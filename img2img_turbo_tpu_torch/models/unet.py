"""UNet2DConditionModel (SD 2.x / SD-Turbo topology), NHWC (counterpart of
`img2img_turbo_tpu/models/unet.py::unet_forward`), with the sketch path's
TwinConv conv_in (`make_twin_conv_in`).

Parameter names are diffusers'. Up-block concats are a plain `torch.cat`
(the JAX `_concat_resnet` split only served TPU VMEM), so each up-block
resnet takes K5 statistics of its concatenated input, as the JAX package
does for any concat it does not split.
"""

from __future__ import annotations

import copy
import functools

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from img2img_turbo_tpu_torch.configs import UNetConfig
from img2img_turbo_tpu_torch.models import layers as L


class BasicTransformerBlock(nn.Module):
    def __init__(self, ch: int, cross_dim: int):
        super().__init__()
        self.norm1 = L.LayerNorm(ch)
        self.attn1 = L.Attention(ch)
        self.norm2 = L.LayerNorm(ch)
        self.attn2 = L.Attention(ch, cross_dim=cross_dim)
        self.norm3 = L.LayerNorm(ch)
        self.ff = L.FeedForward(ch)


class Transformer2DModel(nn.Module):
    """use_linear_projection=True, one BasicTransformerBlock."""

    def __init__(self, ch: int, num_heads: int, cfg: UNetConfig):
        super().__init__()
        self.cfg, self.num_heads = cfg, num_heads
        self.norm = L.GroupNorm(cfg.norm_num_groups, ch, cfg.attn_norm_eps)
        self.proj_in = L.Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(ch, cfg.cross_attention_dim)])
        self.proj_out = L.Linear(ch, ch)

    def forward(self, x, context, *, kernels: bool, x_stats=None, tp=None):
        b, h, w, c = x.shape
        cfg, heads = self.cfg, self.num_heads
        hidden = L.group_norm(self.norm, x, cfg.norm_num_groups,
                              cfg.attn_norm_eps, x_stats, kernels=kernels)
        hidden = L.linear_fused(self.proj_in, hidden.reshape(b, h * w, c),
                                kernels=kernels)
        blk = self.transformer_blocks[0]
        hidden = L.attention_block(blk.attn1, blk.norm1, hidden,
                                   num_heads=heads, kernels=kernels, tp=tp)
        hidden = L.attention_block(blk.attn2, blk.norm2, hidden, context,
                                   num_heads=heads, kernels=kernels, tp=tp)
        hidden = L.geglu_ff_block(blk.ff, blk.norm3, hidden, kernels=kernels,
                                  tp=tp)
        hidden = L.linear_fused(self.proj_out, hidden,
                                residual=x.reshape(b, h * w, c),
                                kernels=kernels)
        return hidden.reshape(b, h, w, c)


class TwinConv(nn.Module):
    """The sketch path's conv_in (reference pix2pix_turbo.py TwinConv): a
    frozen pretrained copy and a trained copy, blended by r in the forward
    with the pretrained branch detached."""

    def __init__(self, conv_in_pretrained: L.Conv2d, conv_in_curr: L.Conv2d):
        super().__init__()
        self.conv_in_pretrained = conv_in_pretrained
        self.conv_in_curr = conv_in_curr


def make_twin_conv_in(unet: "UNet2DConditionModel"):
    """Replace `unet.conv_in` by a TwinConv of a copy of it (pretrained)
    and itself (current), in place (unet.py:261-272); a UNet that already
    has one is returned as it is."""
    if not isinstance(unet.conv_in, TwinConv):
        unet.conv_in = TwinConv(copy.deepcopy(unet.conv_in), unet.conv_in)
    return unet


class _MidBlock(nn.Module):
    def __init__(self, ch, heads, temb_dim, cfg):
        super().__init__()
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        self.resnets = nn.ModuleList([
            L.ResnetBlock2D(ch, ch, g, eps, temb_dim),
            L.ResnetBlock2D(ch, ch, g, eps, temb_dim)])
        self.attentions = nn.ModuleList([Transformer2DModel(ch, heads, cfg)])


class _TimeEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = L.Linear(in_dim, dim)
        self.linear_2 = L.Linear(dim, dim)


class UNet2DConditionModel(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        chans, n = cfg.block_out_channels, cfg.num_levels
        g, eps, temb = cfg.norm_num_groups, cfg.norm_eps, cfg.time_embed_dim
        head_dim = chans[0] // cfg.attention_head_dim[0]
        self.conv_in = L.Conv2d(cfg.in_channels, chans[0], 3)
        self.time_embedding = _TimeEmbedding(chans[0], temb)

        down = []
        in_ch = chans[0]
        for i, out_ch in enumerate(chans):
            resnets = [L.ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch,
                                       g, eps, temb)
                       for j in range(cfg.layers_per_block)]
            attns = ([Transformer2DModel(out_ch, out_ch // head_dim, cfg)
                      for _ in range(cfg.layers_per_block)]
                     if cfg.transformer_levels[i] else [])
            ds = L.Conv2d(out_ch, out_ch, 3) if i < n - 1 else None
            down.append(L.Block(resnets, attns, ds, "down"))
            in_ch = out_ch
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = _MidBlock(chans[-1], chans[-1] // head_dim, temb,
                                   cfg)

        rev = list(reversed(chans))
        rev_t = list(reversed(cfg.transformer_levels))
        up = []
        prev_out = chans[-1]
        for i in range(n):
            out_ch, input_ch = rev[i], rev[min(i + 1, n - 1)]
            resnets = []
            for j in range(cfg.layers_per_block + 1):
                res_skip = input_ch if j == cfg.layers_per_block else out_ch
                res_in = prev_out if j == 0 else out_ch
                resnets.append(L.ResnetBlock2D(res_in + res_skip, out_ch, g,
                                               eps, temb))
            attns = ([Transformer2DModel(out_ch, out_ch // head_dim, cfg)
                      for _ in range(cfg.layers_per_block + 1)]
                     if rev_t[i] else [])
            us = L.Upsample2xConv(out_ch, out_ch, 3) if i < n - 1 else None
            up.append(L.Block(resnets, attns, us, "up"))
            prev_out = out_ch
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = L.GroupNorm(g, chans[0], eps)
        self.conv_out = L.Conv2d(chans[0], cfg.out_channels, 3)

    def forward(self, x, timesteps, context, *, kernels: bool,
                remat: bool = False, r=None, tp=None):
        """x: (B, H, W, 4) latents; timesteps: (B,) int; context:
        (B, 77, cross_dim). Returns eps (B, H, W, 4). remat: recompute each
        down, mid and up block in the backward (torch.utils.checkpoint,
        non-reentrant), as the JAX package's `remat=True` does for
        training; a recompute launches the block's kernels again. r: the
        TwinConv blend factor (a float or 0-d tensor), required when
        conv_in is a TwinConv and unused otherwise, as in the JAX
        package. tp: the mesh of a model axis over which
        `parallel.tensor.shard_module` sharded this UNet (every rank of the
        model group calls forward alike and gets the whole eps; under
        autograd its backward, and with remat each block's recompute, runs
        the same collectives in the same order on every rank, so the
        gradients reaching replicated inputs and trainables are whole and
        the same on every rank: `models/layers.py`)."""
        cfg = self.cfg
        temb = L.timestep_embedding(timesteps, cfg.block_out_channels[0],
                                    cfg.flip_sin_to_cos, cfg.freq_shift)
        te = self.time_embedding
        temb = L.linear(te.linear_2,
                        L.silu(L.linear(te.linear_1, temb.to(x.dtype))))

        def run_down_block(block, sample, temb, context):
            attns = getattr(block, "attentions", None)
            stats = None
            outs = []
            for j, res in enumerate(block.resnets):
                # resnet conv2 -> transformer GN (or the next resnet's GN1
                # in attention-free blocks); the chain breaks at the
                # transformer's residual add and at the downsample
                sample, stats = res(sample, temb, kernels=kernels,
                                    x_stats=stats, emit_stats=True, tp=tp)
                if attns is not None:
                    sample = attns[j](sample, context, kernels=kernels,
                                      x_stats=stats, tp=tp)
                    stats = None
                outs.append(sample)
            if hasattr(block, "downsamplers"):
                sample = L.downsample2x_conv(block.downsamplers[0].conv,
                                             sample, pad_lo=1,
                                             kernels=kernels, tp=tp)
                outs.append(sample)
            return sample, outs

        def run_mid(sample, temb, context):
            mid = self.mid_block
            sample, stats = mid.resnets[0](sample, temb, kernels=kernels,
                                           emit_stats=True, tp=tp)
            sample = mid.attentions[0](sample, context, kernels=kernels,
                                       x_stats=stats, tp=tp)
            return mid.resnets[1](sample, temb, kernels=kernels, tp=tp)

        def run_up_block(block, sample, res_samples, temb, context, size):
            attns = getattr(block, "attentions", None)
            for j, res in enumerate(block.resnets):
                cat = torch.cat([sample, res_samples[-(j + 1)]], dim=-1)
                sample, stats = res(cat, temb, kernels=kernels,
                                    emit_stats=True, tp=tp)
                if attns is not None:
                    sample = attns[j](sample, context, kernels=kernels,
                                      x_stats=stats, tp=tp)
            if hasattr(block, "upsamplers"):
                conv = block.upsamplers[0].conv
                h, w = sample.shape[1:3]
                if size != (2 * h, 2 * w):
                    # odd skip sizes: torch-nearest upsample to the stored
                    # residual's size, then a plain conv (unet.py:350-355)
                    sample = L.conv2d(conv, L.upsample_nearest_to(sample, size),
                                      tp=tp)
                else:
                    sample = L.upsample2x_conv(conv, sample, kernels=kernels,
                                               tp=tp)
            return sample

        if remat:
            def ckpt(fn):
                return functools.partial(checkpoint, fn, use_reentrant=False)
            run_down_block, run_mid, run_up_block = (
                ckpt(run_down_block), ckpt(run_mid), ckpt(run_up_block))

        if isinstance(self.conv_in, TwinConv):
            if r is None:
                raise ValueError("a TwinConv conv_in needs the blend factor r")
            r = torch.as_tensor(r, dtype=x.dtype, device=x.device)
            x1 = L.plain_conv3x3(self.conv_in.conv_in_pretrained, x,
                                 kernels=kernels, tp=tp).detach()
            x2 = L.plain_conv3x3(self.conv_in.conv_in_curr, x,
                                 kernels=kernels, tp=tp)
            sample = x1 * (1.0 - r) + x2 * r
        else:
            sample = L.plain_conv3x3(self.conv_in, x, kernels=kernels, tp=tp)
        res_stack = [sample]
        for block in self.down_blocks:
            sample, outs = run_down_block(block, sample, temb, context)
            res_stack.extend(outs)

        sample = run_mid(sample, temb, context)

        for block in self.up_blocks:
            k = len(block.resnets)
            res_samples, res_stack = res_stack[-k:], res_stack[:-k]
            size = tuple(res_stack[-1].shape[1:3]) if res_stack else None
            sample = run_up_block(block, sample, res_samples, temb, context,
                                  size)

        return L.gn_silu_conv(self.conv_norm_out, self.conv_out, sample,
                              cfg.norm_num_groups, cfg.norm_eps,
                              kernels=kernels, tp=tp)
