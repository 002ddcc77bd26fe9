"""OpenAI-CLIP (ViT image tower and text tower with projections), written
by hand: the counterpart of `img2img_turbo_tpu/models/clip_vit.py`. It
feeds the CLIP-similarity loss and is the frozen backbone of the
vision-aided discriminator (`models/discriminator.py`), which taps the
per-block token features that `vision_forward` returns.

Parameter names are transformers' CLIPModel names (`vision_model.*`,
`text_model.*`, `visual_projection`, `text_projection`, `logit_scale`);
`convert_clip_state_dict` maps an OpenAI `clip` state dict or a
transformers CLIPModel one onto them.
The JAX package runs these towers in XLA ops, so the port runs them in
plain PyTorch, in the input's dtype with weights cast at use.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.nn as nn

from img2img_turbo_tpu_torch.models import layers as L
from img2img_turbo_tpu_torch.models.clip_text import (ACTIVATIONS,
                                                      Embeddings, Encoder,
                                                      EncoderLayer,
                                                      causal_bias)


@dataclasses.dataclass(frozen=True)
class CLIPViTConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    projection_dim: int = 512
    # text tower
    vocab_size: int = 49408
    text_hidden: int = 512
    text_layers: int = 12
    text_heads: int = 8
    max_positions: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"  # OpenAI CLIP uses QuickGELU


CLIP_VIT_B32 = CLIPViTConfig()
TINY_CLIP_VIT = CLIPViTConfig(image_size=64, patch_size=16, hidden_size=32,
                              num_layers=2, num_heads=4,
                              intermediate_size=64, projection_dim=16,
                              vocab_size=1000, text_hidden=32, text_layers=2,
                              text_heads=4)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPViTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(d))
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n, d)


class VisionModel(nn.Module):
    def __init__(self, cfg: CLIPViTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.embeddings = VisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(d, cfg.layer_norm_eps)
        self.encoder = Encoder([
            EncoderLayer(d, cfg.intermediate_size, cfg.layer_norm_eps)
            for _ in range(cfg.num_layers)])
        self.post_layernorm = nn.LayerNorm(d, cfg.layer_norm_eps)


class TextModel(nn.Module):
    def __init__(self, cfg: CLIPViTConfig):
        super().__init__()
        d = cfg.text_hidden
        self.embeddings = Embeddings(cfg.vocab_size, d, cfg.max_positions)
        self.encoder = Encoder([EncoderLayer(d, 4 * d, cfg.layer_norm_eps)
                                for _ in range(cfg.text_layers)])
        self.final_layer_norm = nn.LayerNorm(d, cfg.layer_norm_eps)


class CLIPVision(nn.Module):
    """The vision tower with its projection (the discriminator backbone)."""

    def __init__(self, cfg: CLIPViTConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = VisionModel(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size,
                                           cfg.projection_dim, bias=False)

    def forward(self, pixels, return_blocks: bool = False):
        """pixels (B, H, W, 3), CLIP-normalised -> (image embedding
        (B, projection_dim), per-block token features [(B, 1+N, D)] or
        None)."""
        cfg, vm = self.cfg, self.vision_model
        emb = vm.embeddings
        x = L.conv2d(emb.patch_embedding, pixels, stride=cfg.patch_size,
                     padding="VALID")
        b, gh, gw, d = x.shape
        x = x.reshape(b, gh * gw, d)
        cls = emb.class_embedding.to(x.dtype).expand(b, 1, d)
        x = torch.cat([cls, x], dim=1) \
            + emb.position_embedding.weight[None].to(x.dtype)
        x = L.layer_norm(vm.pre_layrnorm, x, cfg.layer_norm_eps)
        act = ACTIVATIONS[cfg.hidden_act]
        blocks = []
        for layer in vm.encoder.layers:
            x = layer(x, cfg.num_heads, act)
            blocks.append(x)
        pooled = L.layer_norm(vm.post_layernorm, x[:, 0], cfg.layer_norm_eps)
        return (L.linear(self.visual_projection, pooled),
                blocks if return_blocks else None)


class CLIPModel(CLIPVision):
    """Both towers and the logit scale (CLIP-sim)."""

    def __init__(self, cfg: CLIPViTConfig):
        super().__init__(cfg)
        self.text_model = TextModel(cfg)
        self.text_projection = nn.Linear(cfg.text_hidden, cfg.projection_dim,
                                         bias=False)
        self.logit_scale = nn.Parameter(torch.zeros(()))

    def text_forward(self, ids):
        """ids (B, 77) int -> (B, projection_dim) text embeddings, pooled
        at the highest id (the end-of-text token)."""
        cfg, tm = self.cfg, self.text_model
        b, s = ids.shape
        x = tm.embeddings.token_embedding.weight[ids] \
            + tm.embeddings.position_embedding.weight[None, :s]
        bias = causal_bias(s, x.device)
        act = ACTIVATIONS[cfg.hidden_act]
        for layer in tm.encoder.layers:
            x = layer(x, cfg.text_heads, act, bias)
        x = L.layer_norm(tm.final_layer_norm, x, cfg.layer_norm_eps)
        pooled = x[torch.arange(b, device=ids.device), ids.argmax(dim=-1)]
        return L.linear(self.text_projection, pooled)


def renorm_signed_to_clip(x):
    """[-1, 1] image -> ImageNet-normalised pixels, in x's dtype, as the
    reference feeds the CLIP-sim model (train_pix2pix_turbo.py:181-184)."""
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).to(x.dtype)
    std = torch.tensor(IMAGENET_STD, device=x.device).to(x.dtype)
    return (x * 0.5 + 0.5 - mean) / std


def clip_similarity(model: CLIPModel, images, text_ids):
    """Cosine similarity * 100 of matched image / text pairs; images
    (B, H, W, 3) in [-1, 1], already resized to the tower's size."""
    iemb, _ = model(renorm_signed_to_clip(images))
    temb = model.text_forward(text_ids)
    iemb = iemb / iemb.norm(dim=-1, keepdim=True)
    temb = temb / temb.norm(dim=-1, keepdim=True)
    return 100.0 * (iemb * temb).sum(-1)


def _openai_blocks(sd, out, src, dst, n_layers):
    """OpenAI resblocks (fused in_proj q/k/v, c_fc, c_proj, ln_1/2) ->
    transformers' CLIPEncoderLayer names."""
    for i in range(n_layers):
        s, d = f"{src}.resblocks.{i}", f"{dst}.layers.{i}"
        for part, t in zip(("q", "k", "v"),
                           sd[s + ".attn.in_proj_weight"].chunk(3)):
            out[f"{d}.self_attn.{part}_proj.weight"] = t
        for part, t in zip(("q", "k", "v"),
                           sd[s + ".attn.in_proj_bias"].chunk(3)):
            out[f"{d}.self_attn.{part}_proj.bias"] = t
        for a, b in (("attn.out_proj", "self_attn.out_proj"),
                     ("ln_1", "layer_norm1"), ("ln_2", "layer_norm2"),
                     ("mlp.c_fc", "mlp.fc1"), ("mlp.c_proj", "mlp.fc2")):
            for field in ("weight", "bias"):
                out[f"{d}.{b}.{field}"] = sd[f"{s}.{a}.{field}"]


def convert_clip_state_dict(sd, cfg: CLIPViTConfig = CLIP_VIT_B32
                            ) -> Dict[str, torch.Tensor]:
    """An OpenAI `clip` state dict (ViT-B-32.pt's, "visual.proj" present)
    or a transformers CLIPModel one ("visual_projection.weight") ->
    CLIPModel's state dict (clip_vit.py:274-340). The vision keys alone
    (`vision_model.*`, `visual_projection.weight`) load a CLIPVision, the
    discriminator's backbone. Without a logit scale in the file it is
    log(1 / 0.07)."""
    out: Dict[str, torch.Tensor] = {}
    if "visual.proj" in sd:
        vm, tm = "vision_model.", "text_model."
        out[vm + "embeddings.patch_embedding.weight"] = sd["visual.conv1.weight"]
        out[vm + "embeddings.class_embedding"] = sd["visual.class_embedding"]
        out[vm + "embeddings.position_embedding.weight"] = \
            sd["visual.positional_embedding"]
        for a, b in (("visual.ln_pre", vm + "pre_layrnorm"),
                     ("visual.ln_post", vm + "post_layernorm"),
                     ("ln_final", tm + "final_layer_norm")):
            for field in ("weight", "bias"):
                out[f"{b}.{field}"] = sd[f"{a}.{field}"]
        _openai_blocks(sd, out, "visual.transformer", vm + "encoder",
                       cfg.num_layers)
        _openai_blocks(sd, out, "transformer", tm + "encoder",
                       cfg.text_layers)
        out["visual_projection.weight"] = sd["visual.proj"].t()
        out[tm + "embeddings.token_embedding.weight"] = \
            sd["token_embedding.weight"]
        out[tm + "embeddings.position_embedding.weight"] = \
            sd["positional_embedding"]
        out["text_projection.weight"] = sd["text_projection"].t()
    elif "visual_projection.weight" in sd:
        for k, v in sd.items():
            if k.endswith("position_ids"):
                continue
            # transformers' older name for the pre-LN
            out[k.replace("vision_model.pre_layernorm.",
                          "vision_model.pre_layrnorm.")] = v
        key = "vision_model.embeddings.class_embedding"
        out[key] = out[key].reshape(-1)
    else:
        raise ValueError(
            "unrecognized CLIP state dict: expected OpenAI ('visual.proj') "
            "or HF CLIPModel ('visual_projection.weight') key layout")
    out["logit_scale"] = torch.as_tensor(
        sd.get("logit_scale", math.log(1.0 / 0.07)),
        dtype=torch.float32).reshape(())
    return {k: v.contiguous() for k, v in out.items()}
