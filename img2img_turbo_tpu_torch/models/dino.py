"""DINO ViT (timm layout) that returns each block's q, k and v
(counterpart of `img2img_turbo_tpu/models/dino.py`), for the DINO-Struct
metric (`metrics/dino_struct.py`).

A block is x + attn(LN(x)), then x + mlp(LN(x)): one fused qkv linear with
bias, exact-GELU MLP, a patch-embedding conv (patch 8 for ViT-B/8), a class
token and a final LN. Parameter names are the torch.hub DINO model's
(`patch_embed.proj`, `cls_token`, `pos_embed`, `blocks.{i}.norm1`,
`.attn.qkv`, `.attn.proj`, `.norm2`, `.mlp.fc1`, `.mlp.fc2`, `norm`). The
position embedding is stored for the 224/8 = 28x28 grid; another grid
takes it resized as `jax.image.resize(..., "bicubic")` resizes it
(dino.py:80-81): Keys cubic with a = -0.5, half-pixel centres, taps outside
the grid dropped and the rest renormalised, the kernel widened on a
downscale (antialias), written here as two explicit resize matrices. The
JAX package computes attention here with einsum and softmax, not a Pallas
kernel, so the port runs plain PyTorch matmuls and softmax, in fp32
statistics.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from img2img_turbo_tpu_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class DINOConfig:
    patch_size: int = 8
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-6


DINO_VITB8 = DINOConfig()
TINY_DINO = DINOConfig(patch_size=8, hidden_size=32, num_layers=2,
                       num_heads=4)
POS_GRID = 28   # the stored position grid: 224 / 8

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def cubic_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float64 matrix of `jax.image.resize(method="bicubic")`
    along one axis: Keys cubic (a = -0.5) at half-pixel centres, the
    kernel stretched by in/out on a downscale, weights over the in-range
    taps renormalised to sum 1, outputs whose centre falls outside the
    input zero."""
    inv = in_size / out_size
    kscale = max(inv, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv - 0.5
    x = np.abs(sample[:, None] - np.arange(in_size, dtype=np.float64)[None]) \
        / kscale
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0,
                 ((1.5 * x - 2.5) * x) * x + 1.0)
    w = np.where(x >= 2.0, 0.0, w)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, 0.0)


class Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)


class Mlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)


class Block(nn.Module):
    def __init__(self, cfg: DINOConfig):
        super().__init__()
        d = cfg.hidden_size
        self.norm1 = nn.LayerNorm(d, cfg.layer_norm_eps)
        self.attn = Attention(d)
        self.norm2 = nn.LayerNorm(d, cfg.layer_norm_eps)
        self.mlp = Mlp(d, d * cfg.mlp_ratio)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: DINOConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size)


class DINO(nn.Module):
    def __init__(self, cfg: DINOConfig = DINO_VITB8):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + POS_GRID ** 2, d))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.norm = nn.LayerNorm(d, cfg.layer_norm_eps)

    def _pos_grid(self, gh: int, gw: int, dtype):
        d = self.cfg.hidden_size
        pos = self.pos_embed[0, 1:].reshape(POS_GRID, POS_GRID, d).float()
        if (gh, gw) != (POS_GRID, POS_GRID):
            wh, ww = (torch.as_tensor(cubic_resize_matrix(POS_GRID, n),
                                      dtype=torch.float32, device=pos.device)
                      for n in (gh, gw))
            pos = torch.einsum("Hh,hwd->Hwd", wh, pos)
            pos = torch.einsum("Ww,hwd->hWd", ww, pos)
        return pos.reshape(1, gh * gw, d).to(dtype)

    def forward(self, pixels) -> Tuple[torch.Tensor, List[Dict]]:
        """pixels: (B, H, W, 3) ImageNet-normalised, H and W divisible by
        the patch (a remainder is dropped, as the VALID conv drops it).
        Returns (the final tokens (B, 1 + N, D), per block {"q", "k", "v"}
        each (B, heads, 1 + N, head_dim))."""
        cfg = self.cfg
        x = L.conv2d(self.patch_embed.proj, pixels, stride=cfg.patch_size,
                     padding="VALID")
        b, gh, gw, d = x.shape
        x = x.reshape(b, gh * gw, d) + self._pos_grid(gh, gw, x.dtype)
        cls = (self.cls_token[0, 0] + self.pos_embed[0, 0]).to(x.dtype)
        x = torch.cat([cls.expand(b, 1, d), x], dim=1)
        h = cfg.num_heads
        hd = d // h
        qkvs = []
        for blk in self.blocks:
            n = x.shape[1]
            hidden = L.layer_norm(blk.norm1, x, cfg.layer_norm_eps)
            qkv = L.linear(blk.attn.qkv, hidden)
            qkv = qkv.reshape(b, n, 3, h, hd).permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]
            qkvs.append({"q": q, "k": k, "v": v})
            scores = (q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5
            probs = torch.softmax(scores, dim=-1).to(v.dtype)
            o = (probs.float() @ v.float()).to(x.dtype)
            o = o.transpose(1, 2).reshape(b, n, d)
            x = x + L.linear(blk.attn.proj, o)
            hidden = L.layer_norm(blk.norm2, x, cfg.layer_norm_eps)
            x = x + L.linear(blk.mlp.fc2,
                             L.gelu(L.linear(blk.mlp.fc1, hidden)))
        return L.layer_norm(self.norm, x, cfg.layer_norm_eps), qkvs


@torch.no_grad()
def random_dino(cfg: DINOConfig, generator: torch.Generator) -> DINO:
    """The model on generator.device with the JAX package's init
    (dino.py:38-67): linears and the patch conv U(+-1/sqrt(fan_in)),
    norms 1 and 0, the class token and the position grid N(0, 0.02), the
    class position 0; drawn in parameter order. Frozen, in eval mode."""
    with torch.device("meta"):
        model = DINO(cfg)
    model = model.to_empty(device=generator.device)
    mods = dict(model.named_modules())
    for name, p in model.named_parameters():
        mod_name, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        mod = mods[mod_name]
        if isinstance(mod, nn.LayerNorm):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "cls_token":
            p.normal_(0.0, 0.02, generator=generator)
        elif leaf == "pos_embed":
            p.normal_(0.0, 0.02, generator=generator)
            p[:, 0].zero_()
        else:
            bound = 1.0 / math.sqrt(math.prod(mod.weight.shape[1:]))
            p.uniform_(-bound, bound, generator=generator)
    return model.requires_grad_(False).eval()


def convert_dino_state_dict(sd, cfg: DINOConfig = DINO_VITB8
                            ) -> Dict[str, torch.Tensor]:
    """A torch.hub DINO state dict -> this module's (dino.py:109-142): the
    hub's names are kept; the keys DINO does not have (a classifier head)
    are dropped, and the position grid must be the stored 28 x 28."""
    with torch.device("meta"):
        want = dict(DINO(cfg).state_dict())
    out = {k: torch.as_tensor(sd[k]).float() for k in want}
    grid = int(round(math.sqrt(out["pos_embed"].shape[1] - 1)))
    if grid != POS_GRID:
        raise ValueError(f"pos_embed holds a {grid}x{grid} grid; the model "
                         f"stores {POS_GRID}x{POS_GRID}")
    return out
