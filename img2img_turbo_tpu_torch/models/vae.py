"""AutoencoderKL with skip taps and fused skip zero-convs (counterpart of
`img2img_turbo_tpu/models/vae.py`).

Parameter names are diffusers' (`encoder.down_blocks.0.resnets.0.conv1.weight`,
`decoder.skip_conv_1.weight`, ...). Activations are NHWC. The encoder
returns its four skip taps (the inputs of its down blocks); the decoder
adds `skip_conv_i(skip * gamma)` before each up block, fused into the
epilogue of the kernel that produces that point (mid res2 for block 0, the
upsample kernel for blocks 1-3).

The model axis (training): every entry point takes `tp`, the mesh of a VAE
that `parallel.tensor.shard_module` sharded, and hands it to the layer
functions, which act on the modules it marked (`tp_sharded`): every conv
but the decoder's conv_out (3 output channels) is column-parallel on the
rank's output channels, the mid attentions and the skip convs stay whole
(departures (b) and (e) of `parallel/tensor.py`). On a whole VAE (the
serving engine's) `tp` changes nothing.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from img2img_turbo_tpu_torch.configs import VAEConfig
from img2img_turbo_tpu_torch.models import layers as L


class VAEAttention(nn.Module):
    """Single-head spatial self-attention with biased q/k/v (SD VAE)."""

    def __init__(self, ch: int, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.group_norm = L.GroupNorm(cfg.norm_num_groups, ch, cfg.norm_eps)
        self.to_q = L.Linear(ch, ch)
        self.to_k = L.Linear(ch, ch)
        self.to_v = L.Linear(ch, ch)
        self.to_out = nn.ModuleList([L.Linear(ch, ch)])

    def forward(self, x, *, kernels: bool, x_stats=None):
        """Whole on every rank under a model axis (its one head cannot be
        split, departure (b)): it takes no `tp`."""
        b, h, w, c = x.shape
        hidden = L.group_norm(self.group_norm, x, self.cfg.norm_num_groups,
                              self.cfg.norm_eps, x_stats, kernels=kernels)
        hidden = hidden.reshape(b, h * w, c)
        q, k, v = L.fused_linears((self.to_q, self.to_k, self.to_v), hidden,
                                  kernels=kernels)
        o = L.multihead_attention(q, k, v, 1, kernels=kernels)
        return L.linear_fused(self.to_out[0], o,
                              residual=x.reshape(b, h * w, c),
                              kernels=kernels).reshape(b, h, w, c)


class MidBlock(nn.Module):
    def __init__(self, ch: int, cfg: VAEConfig):
        super().__init__()
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        self.resnets = nn.ModuleList([L.ResnetBlock2D(ch, ch, g, eps),
                                      L.ResnetBlock2D(ch, ch, g, eps)])
        self.attentions = nn.ModuleList([VAEAttention(ch, cfg)])

    def forward(self, x, *, kernels: bool, x_stats=None,
                emit_stats: bool = False, epilogue_skip=None, tp=None):
        x, s = self.resnets[0](x, kernels=kernels, x_stats=x_stats,
                               emit_stats=True, tp=tp)
        x = self.attentions[0](x, kernels=kernels, x_stats=s)
        return self.resnets[1](x, kernels=kernels, emit_stats=emit_stats,
                               epilogue_skip=epilogue_skip, tp=tp)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        chans, g, eps = cfg.block_out_channels, cfg.norm_num_groups, \
            cfg.norm_eps
        self.conv_in = L.Conv2d(cfg.in_channels, chans[0], 3)
        blocks = []
        in_ch = chans[0]
        for i, out_ch in enumerate(chans):
            resnets = [L.ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch,
                                       g, eps)
                       for j in range(cfg.layers_per_block)]
            down = (L.Conv2d(out_ch, out_ch, 3)
                    if i < cfg.num_levels - 1 else None)
            blocks.append(L.Block(resnets, conv=down, kind="down"))
            in_ch = out_ch
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock(chans[-1], cfg)
        self.conv_norm_out = L.GroupNorm(g, chans[-1], eps)
        self.conv_out = L.Conv2d(chans[-1], 2 * cfg.latent_channels, 3)

    def forward(self, x, *, kernels: bool, tp=None):
        """-> (moments (B, H/8, W/8, 2*latent), skips[4]); skips[i] is the
        input of down block i."""
        cfg = self.cfg
        sample, stats = L.plain_conv3x3(self.conv_in, x, emit_stats=True,
                                        kernels=kernels, tp=tp)
        skips = []
        for block in self.down_blocks:
            skips.append(sample)
            has_down = hasattr(block, "downsamplers")
            n_res = len(block.resnets)
            for j, res in enumerate(block.resnets):
                # the downsample conv reads raw activations (no GN), so the
                # block's last resnet emits stats only when mid comes next
                emit = not (has_down and j == n_res - 1)
                out = res(sample, kernels=kernels, x_stats=stats,
                          emit_stats=emit, tp=tp)
                sample, stats = out if emit else (out, None)
            if has_down:
                # K6 emits the stats of its output for the next GroupNorm
                sample, stats = L.downsample2x_conv(
                    block.downsamplers[0].conv, sample, pad_lo=0,
                    emit_stats=True, kernels=kernels, tp=tp)
        sample, stats = self.mid_block(sample, kernels=kernels,
                                       x_stats=stats, emit_stats=True, tp=tp)
        sample = L.gn_silu_conv(self.conv_norm_out, self.conv_out, sample,
                                cfg.norm_num_groups, cfg.norm_eps,
                                kernels=kernels, x_stats=stats, tp=tp)
        return sample, skips


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, with_skip_convs: bool = True):
        super().__init__()
        self.cfg = cfg
        chans = list(reversed(cfg.block_out_channels))
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        self.conv_in = L.Conv2d(cfg.latent_channels, chans[0], 3)
        self.mid_block = MidBlock(chans[0], cfg)
        blocks = []
        in_ch = chans[0]
        for i, out_ch in enumerate(chans):
            resnets = [L.ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch,
                                       g, eps)
                       for j in range(cfg.layers_per_block + 1)]
            up = (L.Upsample2xConv(out_ch, out_ch, 3)
                  if i < cfg.num_levels - 1 else None)
            blocks.append(L.Block(resnets, conv=up, kind="up"))
            in_ch = out_ch
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = L.GroupNorm(g, chans[-1], eps)
        self.conv_out = L.Conv2d(chans[-1], cfg.out_channels, 3)
        if with_skip_convs:
            for i, (ic, oc) in enumerate(cfg.skip_conv_channels):
                setattr(self, f"skip_conv_{i + 1}",
                        L.Conv2d(ic, oc, 1, bias=False))

    def forward(self, z, skips: Optional[List[torch.Tensor]] = None,
                gamma=1.0, *, kernels: bool, tp=None):
        """gamma scales each skip before its zero-conv: a float, or a 0-d
        tensor (the sketch path's runtime r)."""
        cfg = self.cfg
        rskips = skips[::-1] if skips is not None else None

        def mk_skip(i):
            if rskips is None:
                return None
            return L.Skip(rskips[i], getattr(self, f"skip_conv_{i + 1}"),
                          gamma)

        sample, stats = L.plain_conv3x3(self.conv_in, z, emit_stats=True,
                                        kernels=kernels, tp=tp)
        sample, stats = self.mid_block(sample, kernels=kernels,
                                       x_stats=stats, emit_stats=True,
                                       epilogue_skip=mk_skip(0), tp=tp)
        for i, block in enumerate(self.up_blocks):
            has_up = hasattr(block, "upsamplers")
            n_res = len(block.resnets)
            for j, res in enumerate(block.resnets):
                emit = not (has_up and j == n_res - 1)
                out = res(sample, kernels=kernels, x_stats=stats,
                          emit_stats=emit, tp=tp)
                sample, stats = out if emit else (out, None)
            if has_up:
                sample, stats = L.upsample2x_conv(
                    block.upsamplers[0].conv, sample, emit_stats=True,
                    skip=mk_skip(i + 1), kernels=kernels, tp=tp)
        return L.gn_silu_conv(self.conv_norm_out, self.conv_out, sample,
                              cfg.norm_num_groups, cfg.norm_eps,
                              kernels=kernels, x_stats=stats, tp=tp)


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig, with_skip_convs: bool = True):
        super().__init__()
        self.cfg = cfg
        lc = cfg.latent_channels
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg, with_skip_convs)
        self.quant_conv = L.Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = L.Conv2d(lc, lc, 1)

    def encode(self, x, *, kernels: bool, noise=None,
               generator: Optional[torch.Generator] = None,
               sample_posterior: bool = True, tp=None):
        """x (B,H,W,3) -> (latents (B,H/8,W/8,4) unscaled, skips). The
        posterior sample takes `noise` when given (shape of the mean), or
        draws it from `generator` on x's device. tp: the model axis's mesh
        of a sharded VAE (module docstring)."""
        moments, skips = self.encoder(x, kernels=kernels, tp=tp)
        moments = L.conv2d(self.quant_conv, moments, tp=tp)
        mean, logvar = moments.chunk(2, dim=-1)
        if not sample_posterior:
            return mean.contiguous(), skips
        logvar = torch.clamp(logvar.float(), -30.0, 20.0)
        std = torch.exp(0.5 * logvar).to(mean.dtype)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device, dtype=mean.dtype)
        return mean + std * noise.to(mean.dtype), skips

    def decode(self, z, skips=None, gamma=1.0, *, kernels: bool, tp=None):
        """Unscaled latents -> image in [-1, 1] range (unclamped). gamma:
        the skip weight, a float or a 0-d tensor. tp: as in `encode`."""
        z = L.conv2d(self.post_quant_conv, z, tp=tp)
        return self.decoder(z, skips, gamma, kernels=kernels, tp=tp)
