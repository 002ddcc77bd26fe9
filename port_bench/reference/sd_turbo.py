"""Plain fp32 PyTorch reference of the one-step generator that the port
serves: SD-Turbo's UNet and VAE (diffusers semantics, NCHW) with
img2img-turbo's four skip convs, LoRA merged here from the factors, the
closed-form x0 step at t=999 and the uint8 cast.

Everything is a function of a {diffusers name: tensor} dict `p` and the
configuration dict of `port_bench/configs/<name>.json`. `q` is applied to
both operands of every conv, linear and attention product: the identity
for the reference, a rounding to a lower precision for the control
(`compare.fp8_round`). See PROVENANCE.md for what this was frozen from and
where it departs.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

Q = Callable[[torch.Tensor], torch.Tensor]
Shapes = List[Tuple[str, Tuple[int, ...]]]


def ident(x):
    return x


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def conv(p, name, x, q: Q, stride=1, padding=1):
    b = p.get(name + ".bias")
    return F.conv2d(q(x), q(p[name + ".weight"]), b, stride=stride,
                    padding=padding)


def linear(p, name, x, q: Q):
    return F.linear(q(x), q(p[name + ".weight"]), p.get(name + ".bias"))


def group_norm(p, name, x, groups, eps):
    return F.group_norm(x, groups, p[name + ".weight"], p[name + ".bias"],
                        eps)


def layer_norm(p, name, x, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                        p[name + ".bias"], eps)


def attention(qt, kt, vt, heads: int, q: Q, max_scores=2 ** 28):
    """softmax(Q K^T / sqrt(hd)) V over (B, S, heads*hd) tensors, in blocks
    of query rows so that a block's scores hold at most `max_scores`
    values."""
    b, sq, d = qt.shape
    hd = d // heads

    def split(t):
        return t.reshape(b, t.shape[1], heads, hd).transpose(1, 2)

    qh, kh, vh = split(q(qt)), split(q(kt)), split(q(vt))
    rows = max(1, max_scores // (b * heads * kh.shape[2]))
    out = []
    for i in range(0, sq, rows):
        s = qh[:, :, i:i + rows] @ kh.transpose(-1, -2) / math.sqrt(hd)
        out.append(q(torch.softmax(s, dim=-1)) @ vh)
    return torch.cat(out, 2).transpose(1, 2).reshape(b, sq, d)


def resnet(p, name, x, groups, eps, q: Q, temb=None):
    h = conv(p, name + ".conv1", F.silu(group_norm(p, name + ".norm1", x,
                                                   groups, eps)), q)
    if temb is not None:
        h = h + linear(p, name + ".time_emb_proj", F.silu(temb),
                       q)[:, :, None, None]
    h = conv(p, name + ".conv2", F.silu(group_norm(p, name + ".norm2", h,
                                                   groups, eps)), q)
    if name + ".conv_shortcut.weight" in p:
        x = conv(p, name + ".conv_shortcut", x, q, padding=0)
    return x + h


def transformer(p, name, x, context, heads, groups, q: Q):
    """Transformer2DModel with use_linear_projection and one
    BasicTransformerBlock (self-attention, cross-attention, GEGLU)."""
    b, c, hh, ww = x.shape
    h = group_norm(p, name + ".norm", x, groups, 1e-6)
    h = linear(p, name + ".proj_in",
               h.permute(0, 2, 3, 1).reshape(b, hh * ww, c), q)
    blk = name + ".transformer_blocks.0"
    for i, ctx in ((1, None), (2, context)):
        a = f"{blk}.attn{i}"
        n = layer_norm(p, f"{blk}.norm{i}", h)
        kv = n if ctx is None else ctx
        o = attention(linear(p, a + ".to_q", n, q),
                      linear(p, a + ".to_k", kv, q),
                      linear(p, a + ".to_v", kv, q), heads, q)
        h = h + linear(p, a + ".to_out.0", o, q)
    n = layer_norm(p, blk + ".norm3", h)
    val, gate = linear(p, blk + ".ff.net.0.proj", n, q).chunk(2, dim=-1)
    h = h + linear(p, blk + ".ff.net.2", val * F.gelu(gate), q)
    h = linear(p, name + ".proj_out", h, q)
    return h.reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x


def vae_attention(p, name, x, groups, eps, q: Q):
    b, c, hh, ww = x.shape
    h = group_norm(p, name + ".group_norm", x, groups, eps)
    h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    o = attention(linear(p, name + ".to_q", h, q),
                  linear(p, name + ".to_k", h, q),
                  linear(p, name + ".to_v", h, q), 1, q)
    o = linear(p, name + ".to_out.0", o, q)
    return o.reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x


def timestep_embedding(t, dim, flip_sin_to_cos=True, shift=0.0):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float64) / (half - shift)).float().to(t.device)
    arg = t.float()[:, None] * freqs[None]
    sin, cos = torch.sin(arg), torch.cos(arg)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


def _unet_levels(cfg):
    chans = cfg["block_out_channels"]
    heads = cfg["attention_head_dim"]          # diffusers: heads per level
    attn = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]
    return chans, heads, attn


def unet(p, cfg, x, t, context, q: Q = ident):
    """eps of the UNet at timesteps t: x (B, 4, h, w), context (B, 77,
    cross_dim)."""
    chans, heads, has_attn = _unet_levels(cfg)
    g, eps, n = cfg["norm_num_groups"], cfg["norm_eps"], len(chans)
    layers = cfg["layers_per_block"]
    temb = timestep_embedding(t, chans[0], cfg["flip_sin_to_cos"],
                              cfg["freq_shift"])
    temb = linear(p, "time_embedding.linear_2", F.silu(
        linear(p, "time_embedding.linear_1", temb, q)), q)
    h = conv(p, "conv_in", x, q)
    stack = [h]
    for i in range(n):
        pre = f"down_blocks.{i}"
        for j in range(layers):
            h = resnet(p, f"{pre}.resnets.{j}", h, g, eps, q, temb)
            if has_attn[i]:
                h = transformer(p, f"{pre}.attentions.{j}", h, context,
                                heads[i], g, q)
            stack.append(h)
        if i < n - 1:
            h = conv(p, f"{pre}.downsamplers.0.conv", h, q, stride=2)
            stack.append(h)
    h = resnet(p, "mid_block.resnets.0", h, g, eps, q, temb)
    h = transformer(p, "mid_block.attentions.0", h, context, heads[-1], g, q)
    h = resnet(p, "mid_block.resnets.1", h, g, eps, q, temb)
    for i in range(n):
        pre, lvl = f"up_blocks.{i}", n - 1 - i
        for j in range(layers + 1):
            h = torch.cat([h, stack.pop()], dim=1)
            h = resnet(p, f"{pre}.resnets.{j}", h, g, eps, q, temb)
            if has_attn[lvl]:
                h = transformer(p, f"{pre}.attentions.{j}", h, context,
                                heads[lvl], g, q)
        if i < n - 1:
            h = F.interpolate(h, size=stack[-1].shape[-2:], mode="nearest")
            h = conv(p, f"{pre}.upsamplers.0.conv", h, q)
    h = F.silu(group_norm(p, "conv_norm_out", h, g, eps))
    return conv(p, "conv_out", h, q)


# ---------------------------------------------------------------------------
# VAE with skip taps and skip convs
# ---------------------------------------------------------------------------


def _mid(p, pre, h, g, eps, q):
    h = resnet(p, pre + ".resnets.0", h, g, eps, q)
    h = vae_attention(p, pre + ".attentions.0", h, g, eps, q)
    return resnet(p, pre + ".resnets.1", h, g, eps, q)


def vae_encode(p, cfg, x, q: Q = ident):
    """x (B, 3, H, W) -> (mean, logvar, skips): skips[i] is the input of
    encoder down block i."""
    chans, g, eps = cfg["block_out_channels"], cfg["norm_num_groups"], \
        cfg["norm_eps"]
    h = conv(p, "encoder.conv_in", x, q)
    skips = []
    for i in range(len(chans)):
        skips.append(h)
        pre = f"encoder.down_blocks.{i}"
        for j in range(cfg["layers_per_block"]):
            h = resnet(p, f"{pre}.resnets.{j}", h, g, eps, q)
        if i < len(chans) - 1:
            h = conv(p, f"{pre}.downsamplers.0.conv", F.pad(h, (0, 1, 0, 1)),
                     q, stride=2, padding=0)
    h = _mid(p, "encoder.mid_block", h, g, eps, q)
    h = conv(p, "encoder.conv_out", F.silu(
        group_norm(p, "encoder.conv_norm_out", h, g, eps)), q)
    mean, logvar = conv(p, "quant_conv", h, q, padding=0).chunk(2, dim=1)
    return mean, logvar, skips


def vae_decode(p, cfg, z, skips, gamma=1.0, q: Q = ident):
    """Unscaled latents -> image (unclamped), each skip through its skip
    conv added before its up block."""
    chans, g, eps = cfg["block_out_channels"], cfg["norm_num_groups"], \
        cfg["norm_eps"]
    h = conv(p, "post_quant_conv", z, q, padding=0)
    h = conv(p, "decoder.conv_in", h, q)
    h = _mid(p, "decoder.mid_block", h, g, eps, q)
    rskips = skips[::-1]
    for i in range(len(chans)):
        h = h + conv(p, f"decoder.skip_conv_{i + 1}", rskips[i] * gamma, q,
                     padding=0)
        pre = f"decoder.up_blocks.{i}"
        for j in range(cfg["layers_per_block"] + 1):
            h = resnet(p, f"{pre}.resnets.{j}", h, g, eps, q)
        if i < len(chans) - 1:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = conv(p, f"{pre}.upsamplers.0.conv", h, q)
    h = F.silu(group_norm(p, "decoder.conv_norm_out", h, g, eps))
    return conv(p, "decoder.conv_out", h, q)


# ---------------------------------------------------------------------------
# Parameter shapes, in the published (diffusers) layout
# ---------------------------------------------------------------------------


def _conv_shape(out: Shapes, name, ci, co, k=3, bias=True):
    out.append((name + ".weight", (co, ci, k, k)))
    if bias:
        out.append((name + ".bias", (co,)))


def _lin_shape(out: Shapes, name, ci, co, bias=True):
    out.append((name + ".weight", (co, ci)))
    if bias:
        out.append((name + ".bias", (co,)))


def _norm_shape(out: Shapes, name, c):
    out += [(name + ".weight", (c,)), (name + ".bias", (c,))]


def _resnet_shape(out: Shapes, name, ci, co, temb=None):
    _norm_shape(out, name + ".norm1", ci)
    _conv_shape(out, name + ".conv1", ci, co)
    if temb:
        _lin_shape(out, name + ".time_emb_proj", temb, co)
    _norm_shape(out, name + ".norm2", co)
    _conv_shape(out, name + ".conv2", co, co)
    if ci != co:
        _conv_shape(out, name + ".conv_shortcut", ci, co, k=1)


def _transformer_shape(out: Shapes, name, c, cross):
    _norm_shape(out, name + ".norm", c)
    _lin_shape(out, name + ".proj_in", c, c)
    blk = name + ".transformer_blocks.0"
    for i, kv in ((1, c), (2, cross)):
        _norm_shape(out, f"{blk}.norm{i}", c)
        _lin_shape(out, f"{blk}.attn{i}.to_q", c, c, bias=False)
        _lin_shape(out, f"{blk}.attn{i}.to_k", kv, c, bias=False)
        _lin_shape(out, f"{blk}.attn{i}.to_v", kv, c, bias=False)
        _lin_shape(out, f"{blk}.attn{i}.to_out.0", c, c)
    _norm_shape(out, blk + ".norm3", c)
    _lin_shape(out, blk + ".ff.net.0.proj", c, 8 * c)
    _lin_shape(out, blk + ".ff.net.2", 4 * c, c)
    _lin_shape(out, name + ".proj_out", c, c)


def unet_shapes(cfg) -> Shapes:
    chans, _, has_attn = _unet_levels(cfg)
    n, layers = len(chans), cfg["layers_per_block"]
    temb, cross = 4 * chans[0], cfg["cross_attention_dim"]
    out: Shapes = []
    _conv_shape(out, "conv_in", cfg["in_channels"], chans[0])
    _lin_shape(out, "time_embedding.linear_1", chans[0], temb)
    _lin_shape(out, "time_embedding.linear_2", temb, temb)
    skip_ch = [chans[0]]
    ci = chans[0]
    for i, co in enumerate(chans):
        for j in range(layers):
            _resnet_shape(out, f"down_blocks.{i}.resnets.{j}",
                          ci if j == 0 else co, co, temb)
            if has_attn[i]:
                _transformer_shape(out, f"down_blocks.{i}.attentions.{j}",
                                   co, cross)
            skip_ch.append(co)
        if i < n - 1:
            _conv_shape(out, f"down_blocks.{i}.downsamplers.0.conv", co, co)
            skip_ch.append(co)
        ci = co
    c = chans[-1]
    _resnet_shape(out, "mid_block.resnets.0", c, c, temb)
    _transformer_shape(out, "mid_block.attentions.0", c, cross)
    _resnet_shape(out, "mid_block.resnets.1", c, c, temb)
    prev = c
    for i in range(n):
        lvl = n - 1 - i
        co = chans[lvl]
        for j in range(layers + 1):
            _resnet_shape(out, f"up_blocks.{i}.resnets.{j}",
                          prev + skip_ch.pop(), co, temb)
            prev = co
            if has_attn[lvl]:
                _transformer_shape(out, f"up_blocks.{i}.attentions.{j}",
                                   co, cross)
        if i < n - 1:
            _conv_shape(out, f"up_blocks.{i}.upsamplers.0.conv", co, co)
    _norm_shape(out, "conv_norm_out", chans[0])
    _conv_shape(out, "conv_out", chans[0], cfg["out_channels"])
    return out


def skip_conv_channels(cfg) -> List[Tuple[int, int]]:
    """(in, out) channels of skip_conv_1..4: skip i carries the input of
    encoder down block n-1-i into the decoder before up block i."""
    chans = cfg["block_out_channels"]
    n, rev = len(chans), list(reversed(chans))
    enc_in = [chans[0]] + list(chans[:-1])    # input channels of block i
    return [(enc_in[n - 1 - i], rev[max(i - 1, 0)]) for i in range(n)]


def vae_shapes(cfg) -> Shapes:
    chans, layers = cfg["block_out_channels"], cfg["layers_per_block"]
    n, lat = len(chans), cfg["latent_channels"]
    out: Shapes = []
    _conv_shape(out, "encoder.conv_in", cfg["in_channels"], chans[0])
    ci = chans[0]
    for i, co in enumerate(chans):
        for j in range(layers):
            _resnet_shape(out, f"encoder.down_blocks.{i}.resnets.{j}",
                          ci if j == 0 else co, co)
        if i < n - 1:
            _conv_shape(out, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                        co, co)
        ci = co
    for side in ("encoder", "decoder"):
        c = chans[-1]
        if side == "decoder":
            _conv_shape(out, "decoder.conv_in", lat, c)
        _resnet_shape(out, f"{side}.mid_block.resnets.0", c, c)
        pre = f"{side}.mid_block.attentions.0"
        _norm_shape(out, pre + ".group_norm", c)
        for lin in ("to_q", "to_k", "to_v", "to_out.0"):
            _lin_shape(out, f"{pre}.{lin}", c, c)
        _resnet_shape(out, f"{side}.mid_block.resnets.1", c, c)
        if side == "encoder":
            _norm_shape(out, "encoder.conv_norm_out", c)
            _conv_shape(out, "encoder.conv_out", c, 2 * lat)
    rev = list(reversed(chans))
    ci = rev[0]
    for i, co in enumerate(rev):
        for j in range(layers + 1):
            _resnet_shape(out, f"decoder.up_blocks.{i}.resnets.{j}",
                          ci if j == 0 else co, co)
        if i < n - 1:
            _conv_shape(out, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                        co, co)
        ci = co
    _norm_shape(out, "decoder.conv_norm_out", rev[-1])
    _conv_shape(out, "decoder.conv_out", rev[-1], cfg["out_channels"])
    for i, (a, b) in enumerate(skip_conv_channels(cfg)):
        _conv_shape(out, f"decoder.skip_conv_{i + 1}", a, b, k=1, bias=False)
    _conv_shape(out, "quant_conv", 2 * lat, 2 * lat, k=1)
    _conv_shape(out, "post_quant_conv", lat, lat, k=1)
    return out


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------


def merge_lora(base: Dict[str, torch.Tensor], adapters) -> Dict:
    """fp32 copies of `base` with every adapter merged: W + alpha/r * B A,
    from peft's factors lora_A (r, in[, k, k]) and lora_B (out, r[, 1, 1])
    (`weights.Adapter`)."""
    p = {k: v.float() for k, v in base.items()}
    for ad in adapters:
        s = ad.alpha / ad.rank
        for name, (a, b) in ad.factors.items():
            a, b = a.float(), b.float()
            b2 = b.reshape(b.shape[0], b.shape[1])
            delta = (b2 @ a.reshape(a.shape[0], -1)).reshape(
                p[name + ".weight"].shape)
            p[name + ".weight"] = p[name + ".weight"] + s * delta
    return p
