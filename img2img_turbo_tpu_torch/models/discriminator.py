"""Vision-aided CLIP discriminator (counterpart of
`img2img_turbo_tpu/models/discriminator.py`): a frozen CLIP ViT backbone
whose token grids after blocks n/3 and 2n/3 and whose projected embedding
feed three small trainable heads with spectral norm, and the multilevel
non-saturating sigmoid GAN loss.

The heads are a flat dictionary of tensors (`init_heads`), so that the
train step hands them to its optimizer as they are:
`spatial.{i}.conv1.*` (768 -> 256, 3x3, stride 2), `spatial.{i}.conv2.*`
(256 -> 1, 1x1), `final.lin1.*` (projection_dim -> 256), `final.lin2.*`
(256 -> 1); conv weights OIHW, linear weights (out, in). The spectral-norm
state is another dictionary of left singular vectors `u`, one per head
weight, advanced once per discriminator pass by `sn_step` and never
optimised. Torch's (out, -1) view of a weight orders its columns
differently from the JAX package's HWIO view, which permutes v but leaves
u and sigma the same.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from img2img_turbo_tpu_torch.models import clip_vit
from img2img_turbo_tpu_torch.ops.image import resize_torch

HEAD_CHANNELS = 256
SN_EPS = 1e-12


def tap_indices(cfg: clip_vit.CLIPViTConfig) -> Tuple[int, int]:
    """After-block indices of the two spatial taps (4 and 8 of 12)."""
    n = cfg.num_layers
    return n // 3, (2 * n) // 3 if n > 2 else n - 1


def head_shapes(cfg: clip_vit.CLIPViTConfig) -> Dict[str, tuple]:
    d, hc = cfg.hidden_size, HEAD_CHANNELS
    out = {}
    for i in range(2):
        out[f"spatial.{i}.conv1"] = (hc, d, 3, 3)
        out[f"spatial.{i}.conv2"] = (1, hc, 1, 1)
    out["final.lin1"] = (hc, cfg.projection_dim)
    out["final.lin2"] = (1, hc)
    return out


def init_heads(cfg: clip_vit.CLIPViTConfig, generator: torch.Generator):
    """Seeded (heads, sn): weights and biases U(+-1/sqrt(fan_in)) as the
    JAX init, u ~ N(0, 1) normalised; fp32 on the generator's device."""
    dev = generator.device
    heads, sn = {}, {}
    for name, shape in head_shapes(cfg).items():
        bound = 1.0 / math.sqrt(math.prod(shape[1:]))
        for leaf, s in (("weight", shape), ("bias", shape[:1])):
            heads[f"{name}.{leaf}"] = (torch.rand(
                s, generator=generator, device=dev) * 2 - 1) * bound
        u = torch.randn(shape[0], generator=generator, device=dev)
        sn[name] = u / u.norm()
    return heads, sn


def _as_matrix(w):
    return w.float().reshape(w.shape[0], -1)


def power_iteration(w, u):
    """One torch-style power iteration: returns the new u."""
    mat = _as_matrix(w)
    v = mat.t() @ u
    v = v / (v.norm() + SN_EPS)
    u_new = mat @ v
    return u_new / (u_new.norm() + SN_EPS)


def spectral_normalize(w, u):
    """w / sigma(w) with sigma from the stored estimate u (a constant);
    differentiable in w."""
    u = u.detach()
    mat = _as_matrix(w)
    v = (mat.t() @ u).detach()
    v = v / (v.norm() + SN_EPS)
    sigma = u @ mat @ v
    return w / sigma.to(w.dtype)


@torch.no_grad()
def sn_step(heads: Dict[str, torch.Tensor], sn: Dict[str, torch.Tensor]):
    """One power iteration on every head weight (torch's train-mode
    per-forward update); returns the new sn dictionary."""
    return {k: power_iteration(heads[k + ".weight"], u) for k, u in sn.items()}


def _sn_conv(heads, sn, name, x, stride=1, pad=0):
    w = spectral_normalize(heads[name + ".weight"], sn[name]).to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, heads[name + ".bias"].to(x.dtype),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _sn_linear(heads, sn, name, x):
    w = spectral_normalize(heads[name + ".weight"], sn[name]).to(x.dtype)
    return F.linear(x, w, heads[name + ".bias"].to(x.dtype))


def discriminator_logits(backbone: clip_vit.CLIPVision, heads, sn,
                         images) -> List[torch.Tensor]:
    """images (B, H, W, 3) in [-1, 1]; the vision_aided preprocessing
    (bicubic to the tower's size, CLIP statistics) in fp32. Returns the
    per-level logits [(B, g', g', 1), (B, g', g', 1), (B, 1)]."""
    cfg = backbone.cfg
    x = images.float() * 0.5 + 0.5
    if x.shape[1] != cfg.image_size or x.shape[2] != cfg.image_size:
        x = resize_torch(x, cfg.image_size, cfg.image_size, "bicubic")
    mean = torch.tensor(clip_vit.CLIP_MEAN, device=x.device)
    std = torch.tensor(clip_vit.CLIP_STD, device=x.device)
    emb, blocks = backbone((x - mean) / std, return_blocks=True)
    g = cfg.image_size // cfg.patch_size
    outs = []
    for i, lvl in enumerate(tap_indices(cfg)):
        tokens = blocks[lvl][:, 1:, :]
        feat = tokens.reshape(tokens.shape[0], g, g, tokens.shape[-1])
        h = F.leaky_relu(_sn_conv(heads, sn, f"spatial.{i}.conv1", feat,
                                  stride=2, pad=1), 0.2)
        outs.append(_sn_conv(heads, sn, f"spatial.{i}.conv2", h))
    h = F.leaky_relu(_sn_linear(heads, sn, "final.lin1", emb), 0.2)
    outs.append(_sn_linear(heads, sn, "final.lin2", h))
    return outs


def disc_loss(backbone, heads, sn, images, *, for_G: bool = False,
              for_real: bool = None, smooth: bool = True):
    """Multilevel sigmoid GAN loss, the sum of per-level means: for_G
    softplus(-x); for_real softplus(-x), with one-sided smoothing
    0.9 softplus(-x) + 0.1 softplus(x) when smooth; fake softplus(x)."""
    total = 0.0
    for lg in discriminator_logits(backbone, heads, sn, images):
        lg = lg.float()
        if for_G:
            loss = F.softplus(-lg)
        elif for_real:
            loss = (0.9 * F.softplus(-lg) + 0.1 * F.softplus(lg)) if smooth \
                else F.softplus(-lg)
        else:
            loss = F.softplus(lg)
        total = total + loss.mean()
    return total
