"""CLIP text encoder, written by hand (counterpart of
`img2img_turbo_tpu/models/clip_text.py`): the OpenCLIP ViT-H text tower as
SD-Turbo ships it (23 layers, width 1024, 16 heads, exact GELU), returning
the final-layer-normed last hidden state with a causal mask and no padding
mask, as `CLIPTextModel(...)[0]`.

Parameter names are transformers' `CLIPTextModel` names without the
`text_model.` prefix. The JAX package runs this tower in XLA ops, so the
port runs it in plain PyTorch: it is frozen, and the train step calls it
once per step under `torch.no_grad()`.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from img2img_turbo_tpu_torch.configs import CLIPTextConfig
from img2img_turbo_tpu_torch.models import layers as L


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {"gelu": L.gelu, "quick_gelu": quick_gelu}


class SelfAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, num_heads: int, bias=None):
        """fp32 scores (+ an additive fp32 bias), softmax cast to v's
        dtype, fp32 accumulation (`clip_text.py:_attn`)."""
        b, s, d = x.shape
        hd = d // num_heads

        def heads(t):
            return t.reshape(b, s, num_heads, hd).transpose(1, 2)

        q, k, v = (heads(L.linear(m, x))
                   for m in (self.q_proj, self.k_proj, self.v_proj))
        scores = (q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5
        if bias is not None:
            scores = scores + bias
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        o = (probs.float() @ v.float()).to(x.dtype)
        return L.linear(self.out_proj, o.transpose(1, 2).reshape(b, s, d))


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class EncoderLayer(nn.Module):
    """A pre-LN transformer block (transformers' CLIPEncoderLayer)."""

    def __init__(self, dim: int, hidden: int, eps: float):
        super().__init__()
        self.eps = eps
        self.layer_norm1 = nn.LayerNorm(dim, eps)
        self.self_attn = SelfAttention(dim)
        self.layer_norm2 = nn.LayerNorm(dim, eps)
        self.mlp = MLP(dim, hidden)

    def forward(self, x, num_heads: int, act, bias=None):
        x = x + self.self_attn(L.layer_norm(self.layer_norm1, x, self.eps),
                               num_heads, bias)
        h = L.layer_norm(self.layer_norm2, x, self.eps)
        return x + L.linear(self.mlp.fc2, act(L.linear(self.mlp.fc1, h)))


def causal_bias(s: int, device):
    """(s, s) fp32 additive mask: 0 on and below the diagonal, the fp32
    minimum above it (transformers' fill)."""
    mask = torch.ones(s, s, dtype=torch.bool, device=device).tril()
    return torch.zeros(s, s, device=device).masked_fill(
        ~mask, torch.finfo(torch.float32).min)


class Embeddings(nn.Module):
    def __init__(self, vocab: int, dim: int, positions: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab, dim)
        self.position_embedding = nn.Embedding(positions, dim)


class Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.embeddings = Embeddings(cfg.vocab_size, d,
                                     cfg.max_position_embeddings)
        self.encoder = Encoder([
            EncoderLayer(d, cfg.intermediate_size, cfg.layer_norm_eps)
            for _ in range(cfg.num_layers)])
        self.final_layer_norm = nn.LayerNorm(d, cfg.layer_norm_eps)

    def forward(self, input_ids):
        """input_ids (B, S) int -> (B, S, hidden), in the parameters'
        dtype."""
        cfg = self.cfg
        s = input_ids.shape[1]
        emb = self.embeddings
        x = emb.token_embedding.weight[input_ids] \
            + emb.position_embedding.weight[None, :s]
        bias = causal_bias(s, x.device)
        act = ACTIVATIONS[cfg.hidden_act]
        for layer in self.encoder.layers:
            x = layer(x, cfg.num_heads, act, bias)
        return L.layer_norm(self.final_layer_norm, x, cfg.layer_norm_eps)
