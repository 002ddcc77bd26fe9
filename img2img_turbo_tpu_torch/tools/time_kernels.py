"""Time kernels of the checkout in the current directory on one CUDA card,
so that two versions of them can be compared in one machine session:

    cd <checkout> && python3 <path>/img2img_turbo_tpu_torch/tools/time_kernels.py [--only du]

The package is imported from the current directory, not from beside this
file: run it from the root of a checkout of another commit to time that
commit's kernels (in ABBA order for a comparison: parent, change, change,
parent). The kernels and their cases, which chip_smoke.py takes from here:

- K1 (`fused_gn_silu_conv3x3`), K4 (`upsample2x_conv3x3`), K5
  (`group_norm_coeffs`: the stats kernel and its combine), K6
  (`downsample2x_conv3x3`) and K7 (`flash_attention_folded_bwd`) at their
  `*_CASES`, K1, K4 and K6 with stats where their path takes them; K1
  beside cuDNN's conv alone (`conv_alone`: F.conv2d, channels_last, on the
  input activated beforehand, which is not K1's function); K1, K4 and K6
  then report their time per 512x512 request and per train step, and K7,
  beside the backward of `F.scaled_dot_product_attention` on the same
  inputs, its time per train step at each head dim (each case weighted by
  its launches in `K1_CASES`, `K4_CASES`, `K6_CASES` and `K7_CASES`);
- K2 (`flash_attention_folded`, with lse) and K9 (`flash_attention`) at
  chip_smoke.py's attention shapes;
- K3 (`fused_matmul.fused`) at the transformer and VAE mid-attention shapes
  of a 512x512 request and a train step; weights are nn.Linear's (Co, C),
  or (C, Co) for a checkout from before that layout (a ValueError on the
  first tells them apart; the values do not matter for a timing);
- du (K8's input gradient, `fused_conv.conv3x3_input_grad` on the
  forward's packed weight, or `layers.conv3x3_input_grad` on the nn.Conv2d
  weight in a checkout from before it) at every shape of the train step
  (`DU_CASES`), then its time per train step (each case weighted by its
  launches in one step).

Each case is timed three ways on seeded bf16 inputs:

- `ms`: one call between two CUDA events, the median of 10 after a warm-up
  (host time included, as chip_smoke.py times a kernel);
- `device_ms`: 20 calls captured in one CUDA graph and replayed between two
  events, per call, the median of 5 replays (no host work between the
  launches; where the capture fails, the kernels' device time under
  torch.profiler);
- `host_us`: the host time of one call, the mean of 50 calls issued back to
  back.

Prints the card's name and power limit, then one JSON object per case.
chip_smoke.py takes its timers from here.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import os
import re
import subprocess
import sys
import time

# (kernel, case, B, Sq, Skv, H, hd); K9 takes (B, H, S, 64) tensors
ATTENTION_CASES = [
    ("K2", "unet self S=4096 H=5", 1, 4096, 4096, 5, 64),
    ("K2", "unet cross S=4096 Skv=77 H=5", 1, 4096, 77, 5, 64),
    ("K2", "unet self S=1024 H=10", 1, 1024, 1024, 10, 64),
    ("K2", "unet cross S=1024 Skv=77 H=10", 1, 1024, 77, 10, 64),
    ("K2", "unet self S=256 H=20", 1, 256, 256, 20, 64),
    ("K2", "unet cross S=256 Skv=77 H=20", 1, 256, 77, 20, 64),
    ("K2", "unet mid self S=64 H=20", 1, 64, 64, 20, 64),
    ("K2", "unet mid cross S=64 Skv=77 H=20", 1, 64, 77, 20, 64),
    ("K2", "vae mid hd=512 S=4096", 1, 4096, 4096, 1, 512),
    ("K2", "unet ragged self S=7350 H=5", 1, 7350, 7350, 5, 64),
    ("K2", "vae mid ragged hd=512 S=7350", 1, 7350, 7350, 1, 512),
    ("K2", "unet self S=1024 H=10 B=2", 2, 1024, 1024, 10, 64),
    ("K9", "self S=4096 H=5", 1, 4096, 4096, 5, 64),
    ("K9", "cross S=4096 Skv=77 H=5", 1, 4096, 77, 5, 64),
    ("K9", "ragged S=7350 H=5", 1, 7350, 7350, 5, 64),
    ("K9", "self S=1024 H=10", 1, 1024, 1024, 10, 64),
    ("K9", "ragged S=1089 H=2", 1, 1089, 1089, 2, 64)]


def k3_shapes(m: int, c: int):
    """K3's launch shapes (M, C, Co, outputs, LN, gate, residual) in one
    SD-Turbo transformer at M rows and C channels, proj_in to proj_out: the
    context K/V (77 x 1024) is separate (`K3_KV_SHAPES`). attn1's and
    attn2's out projections and proj_out share the residual shape."""
    return [(m, c, c, 1, False, False, False),        # proj_in
            (m, c, c, 3, True, False, False),         # LN1 + q, k, v
            (m, c, c, 1, False, False, True),         # out proj + residual
            (m, c, c, 1, True, False, False),         # LN2 + q
            (m, c, 4 * c, 1, True, True, False),      # LN3 + GEGLU
            (m, 4 * c, c, 1, False, False, True)]     # ff out + residual


# the context K/V of the cross-attention at each UNet width
K3_KV_SHAPES = [(77, 1024, c, 2, False, False, False) for c in (320, 640, 1280)]
# the VAE mid attention at the latent's rows: q, k, v, then out + residual
def k3_vae_shapes(m: int):
    return [(m, 512, 512, 3, False, False, False),
            (m, 512, 512, 1, False, False, True)]


# Every K3 shape of a 512x512 request or train step (transformer rows S at
# C = 320, 640, 1280, 1280 for 64^2, 32^2, 16^2, 8^2 latents) and of an
# 840x560 request (latent 105x70: 7350, 1855, 486, 126 rows).
K3_SHAPES = sorted(set(
    [s for m, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280),
                    (7350, 320), (1855, 640), (486, 1280), (126, 1280))
     for s in k3_shapes(m, c)]
    + K3_KV_SHAPES + k3_vae_shapes(4096) + k3_vae_shapes(7350)),
    key=lambda s: (-s[0], s))

# K8's du: every shape of the 512x512 paired train step (each fused GN
# conv's backward, of the forward conv C -> Co), with its launches in one
# step (95 a generator pass, 2 passes; chip_smoke.py fails if a step counts
# others), and three a step does not run: one 256^2 256->128 case kept
# from earlier comparisons, a ragged one (the 840x560 request's latent) and
# a long-K one (288 steps a block, so its rate is the main loop's alone):
# (case, B, H, W, C, Co, launches per step)
DU_CASES = [
    ("du vae 512^2 128->128", 1, 512, 512, 128, 128, 18),
    ("du vae dec conv_out 128->3", 1, 512, 512, 128, 3, 2),
    ("du vae 256^2 256->128", 1, 256, 256, 256, 128, 0),
    ("du vae enc conv_out 512->8", 1, 64, 64, 512, 8, 2),
    ("du unet 64^2 320->320", 1, 64, 64, 320, 320, 14),
    ("du unet conv_out 320->4", 1, 64, 64, 320, 4, 2),
    ("du unet 8^2 2560->1280 split-K", 1, 8, 8, 2560, 1280, 6),
    ("du vae 512^2 256->128", 1, 512, 512, 256, 128, 2),
    ("du vae 256^2 128->256", 1, 256, 256, 128, 256, 2),
    ("du vae 256^2 256->256", 1, 256, 256, 256, 256, 16),
    ("du vae 256^2 512->256", 1, 256, 256, 512, 256, 2),
    ("du vae 128^2 256->512", 1, 128, 128, 256, 512, 2),
    ("du vae 128^2 512->512", 1, 128, 128, 512, 512, 18),
    ("du vae 64^2 512->512", 1, 64, 64, 512, 512, 36),
    ("du unet 64^2 960->320", 1, 64, 64, 960, 320, 2),
    ("du unet 64^2 640->320", 1, 64, 64, 640, 320, 4),
    ("du unet 32^2 320->640", 1, 32, 32, 320, 640, 2),
    ("du unet 32^2 640->640", 1, 32, 32, 640, 640, 12),
    ("du unet 32^2 1920->640", 1, 32, 32, 1920, 640, 2),
    ("du unet 32^2 1280->640", 1, 32, 32, 1280, 640, 2),
    ("du unet 32^2 960->640", 1, 32, 32, 960, 640, 2),
    ("du unet 16^2 640->1280", 1, 16, 16, 640, 1280, 2),
    ("du unet 16^2 1280->1280", 1, 16, 16, 1280, 1280, 12),
    ("du unet 16^2 2560->1280", 1, 16, 16, 2560, 1280, 4),
    ("du unet 16^2 1920->1280", 1, 16, 16, 1920, 1280, 2),
    ("du unet 8^2 1280->1280", 1, 8, 8, 1280, 1280, 22),
    ("du ragged 105x70 640->640", 1, 105, 70, 640, 640, 0),
    ("du long-K 256x128 128->2048", 1, 256, 128, 128, 2048, 0)]

# K1: every forward shape of a 512x512 request and a paired train step
# (the train step: each generator pass runs the request's launches and
# again the UNet's 44 resnet convs, recomputed), and of an 840x560 request
# (launches 0): (case, B, H, W, C, Co, GN prologue, extra bias, residual,
# Csk, stats, launches per request, per step); chip_smoke.py fails if a
# path counts others
K1_CASES = [
    ('vae 512x512 3->128 conv_in', 1, 512, 512, 3, 128, False, False, False, 0, True, 1, 2),
    ('vae 512x512 128->3 conv_out no stats', 1, 512, 512, 128, 3, True, False, False, 0, False, 1, 2),
    ('vae 512x512 128->128', 1, 512, 512, 128, 128, True, False, False, 0, True, 4, 8),
    ('vae 512x512 128->128 skip 256', 1, 512, 512, 128, 128, True, False, False, 256, True, 1, 2),
    ('vae 512x512 128->128 res no stats', 1, 512, 512, 128, 128, True, False, True, 0, False, 1, 2),
    ('vae 512x512 128->128 res', 1, 512, 512, 128, 128, True, False, True, 0, True, 3, 6),
    ('vae 512x512 256->128', 1, 512, 512, 256, 128, True, False, False, 0, True, 1, 2),
    ('vae 256x256 128->256', 1, 256, 256, 128, 256, True, False, False, 0, True, 1, 2),
    ('vae 256x256 256->256', 1, 256, 256, 256, 256, True, False, False, 0, True, 3, 6),
    ('vae 256x256 256->256 skip 128', 1, 256, 256, 256, 256, True, False, False, 128, True, 1, 2),
    ('vae 256x256 256->256 skip 512', 1, 256, 256, 256, 256, True, False, False, 512, True, 1, 2),
    ('vae 256x256 256->256 res no stats', 1, 256, 256, 256, 256, True, False, True, 0, False, 2, 4),
    ('vae 256x256 256->256 res', 1, 256, 256, 256, 256, True, False, True, 0, True, 1, 2),
    ('vae 256x256 512->256', 1, 256, 256, 512, 256, True, False, False, 0, True, 1, 2),
    ('vae 128x128 256->512', 1, 128, 128, 256, 512, True, False, False, 0, True, 1, 2),
    ('vae 128x128 512->512', 1, 128, 128, 512, 512, True, False, False, 0, True, 4, 8),
    ('vae 128x128 512->512 skip 256', 1, 128, 128, 512, 512, True, False, False, 256, True, 1, 2),
    ('vae 128x128 512->512 res no stats', 1, 128, 128, 512, 512, True, False, True, 0, False, 2, 4),
    ('vae 128x128 512->512 res', 1, 128, 128, 512, 512, True, False, True, 0, True, 2, 4),
    ('vae 64x64 4->512 conv_in', 1, 64, 64, 4, 512, False, False, False, 0, True, 1, 2),
    ('vae 64x64 512->8 conv_out no stats', 1, 64, 64, 512, 8, True, False, False, 0, False, 1, 2),
    ('vae 64x64 512->512', 1, 64, 64, 512, 512, True, False, False, 0, True, 9, 18),
    ('vae 64x64 512->512 res no stats', 1, 64, 64, 512, 512, True, False, True, 0, False, 1, 2),
    ('vae 64x64 512->512 res', 1, 64, 64, 512, 512, True, False, True, 0, True, 7, 14),
    ('vae 64x64 512->512 res skip 512', 1, 64, 64, 512, 512, True, False, True, 512, True, 1, 2),
    ('unet 64x64 4->320 conv_in no stats', 1, 64, 64, 4, 320, False, False, False, 0, False, 1, 2),
    ('unet 64x64 320->4 conv_out no stats', 1, 64, 64, 320, 4, True, False, False, 0, False, 1, 2),
    ('unet 64x64 320->320 skip 640', 1, 64, 64, 320, 320, True, False, False, 640, True, 2, 8),
    ('unet 64x64 320->320 skip 960', 1, 64, 64, 320, 320, True, False, False, 960, True, 1, 4),
    ('unet 64x64 320->320 res', 1, 64, 64, 320, 320, True, False, True, 0, True, 2, 8),
    ('unet 64x64 320->320 eb', 1, 64, 64, 320, 320, True, True, False, 0, True, 2, 8),
    ('unet 64x64 640->320 eb', 1, 64, 64, 640, 320, True, True, False, 0, True, 2, 8),
    ('unet 64x64 960->320 eb', 1, 64, 64, 960, 320, True, True, False, 0, True, 1, 4),
    ('unet 32x32 320->640 eb', 1, 32, 32, 320, 640, True, True, False, 0, True, 1, 4),
    ('unet 32x32 640->640 skip 320', 1, 32, 32, 640, 640, True, False, False, 320, True, 1, 4),
    ('unet 32x32 640->640 skip 960', 1, 32, 32, 640, 640, True, False, False, 960, True, 1, 4),
    ('unet 32x32 640->640 skip 1280', 1, 32, 32, 640, 640, True, False, False, 1280, True, 1, 4),
    ('unet 32x32 640->640 skip 1920', 1, 32, 32, 640, 640, True, False, False, 1920, True, 1, 4),
    ('unet 32x32 640->640 res', 1, 32, 32, 640, 640, True, False, True, 0, True, 1, 4),
    ('unet 32x32 640->640 eb', 1, 32, 32, 640, 640, True, True, False, 0, True, 1, 4),
    ('unet 32x32 960->640 eb', 1, 32, 32, 960, 640, True, True, False, 0, True, 1, 4),
    ('unet 32x32 1280->640 eb', 1, 32, 32, 1280, 640, True, True, False, 0, True, 1, 4),
    ('unet 32x32 1920->640 eb', 1, 32, 32, 1920, 640, True, True, False, 0, True, 1, 4),
    ('unet 16x16 640->1280 eb', 1, 16, 16, 640, 1280, True, True, False, 0, True, 1, 4),
    ('unet 16x16 1280->1280 skip 640', 1, 16, 16, 1280, 1280, True, False, False, 640, True, 1, 4),
    ('unet 16x16 1280->1280 skip 1920', 1, 16, 16, 1280, 1280, True, False, False, 1920, True, 1, 4),
    ('unet 16x16 1280->1280 skip 2560', 1, 16, 16, 1280, 1280, True, False, False, 2560, True, 2, 8),
    ('unet 16x16 1280->1280 res', 1, 16, 16, 1280, 1280, True, False, True, 0, True, 1, 4),
    ('unet 16x16 1280->1280 eb', 1, 16, 16, 1280, 1280, True, True, False, 0, True, 1, 4),
    ('unet 16x16 1920->1280 eb', 1, 16, 16, 1920, 1280, True, True, False, 0, True, 1, 4),
    ('unet 16x16 2560->1280 eb', 1, 16, 16, 2560, 1280, True, True, False, 0, True, 2, 8),
    ('unet 8x8 1280->1280 skip 2560', 1, 8, 8, 1280, 1280, True, False, False, 2560, True, 3, 12),
    ('unet 8x8 1280->1280 res no stats', 1, 8, 8, 1280, 1280, True, False, True, 0, False, 1, 4),
    ('unet 8x8 1280->1280 res', 1, 8, 8, 1280, 1280, True, False, True, 0, True, 3, 12),
    ('unet 8x8 1280->1280 eb', 1, 8, 8, 1280, 1280, True, True, False, 0, True, 4, 16),
    ('unet 8x8 2560->1280 eb', 1, 8, 8, 2560, 1280, True, True, False, 0, True, 3, 12),
    ('vae 560x840 3->128 conv_in', 1, 560, 840, 3, 128, False, False, False, 0, True, 0, 0),
    ('vae 560x840 128->3 conv_out no stats', 1, 560, 840, 128, 3, True, False, False, 0, False, 0, 0),
    ('vae 560x840 128->128', 1, 560, 840, 128, 128, True, False, False, 0, True, 0, 0),
    ('vae 560x840 128->128 skip 256', 1, 560, 840, 128, 128, True, False, False, 256, True, 0, 0),
    ('vae 560x840 128->128 res no stats', 1, 560, 840, 128, 128, True, False, True, 0, False, 0, 0),
    ('vae 560x840 128->128 res', 1, 560, 840, 128, 128, True, False, True, 0, True, 0, 0),
    ('vae 560x840 256->128', 1, 560, 840, 256, 128, True, False, False, 0, True, 0, 0),
    ('vae 280x420 128->256', 1, 280, 420, 128, 256, True, False, False, 0, True, 0, 0),
    ('vae 280x420 256->256', 1, 280, 420, 256, 256, True, False, False, 0, True, 0, 0),
    ('vae 280x420 256->256 skip 128', 1, 280, 420, 256, 256, True, False, False, 128, True, 0, 0),
    ('vae 280x420 256->256 skip 512', 1, 280, 420, 256, 256, True, False, False, 512, True, 0, 0),
    ('vae 280x420 256->256 res no stats', 1, 280, 420, 256, 256, True, False, True, 0, False, 0, 0),
    ('vae 280x420 256->256 res', 1, 280, 420, 256, 256, True, False, True, 0, True, 0, 0),
    ('vae 280x420 512->256', 1, 280, 420, 512, 256, True, False, False, 0, True, 0, 0),
    ('vae 140x210 256->512', 1, 140, 210, 256, 512, True, False, False, 0, True, 0, 0),
    ('vae 140x210 512->512', 1, 140, 210, 512, 512, True, False, False, 0, True, 0, 0),
    ('vae 140x210 512->512 skip 256', 1, 140, 210, 512, 512, True, False, False, 256, True, 0, 0),
    ('vae 140x210 512->512 res no stats', 1, 140, 210, 512, 512, True, False, True, 0, False, 0, 0),
    ('vae 140x210 512->512 res', 1, 140, 210, 512, 512, True, False, True, 0, True, 0, 0),
    ('vae 70x105 4->512 conv_in', 1, 70, 105, 4, 512, False, False, False, 0, True, 0, 0),
    ('vae 70x105 512->8 conv_out no stats', 1, 70, 105, 512, 8, True, False, False, 0, False, 0, 0),
    ('vae 70x105 512->512', 1, 70, 105, 512, 512, True, False, False, 0, True, 0, 0),
    ('vae 70x105 512->512 res no stats', 1, 70, 105, 512, 512, True, False, True, 0, False, 0, 0),
    ('vae 70x105 512->512 res', 1, 70, 105, 512, 512, True, False, True, 0, True, 0, 0),
    ('vae 70x105 512->512 res skip 512', 1, 70, 105, 512, 512, True, False, True, 512, True, 0, 0),
    ('unet 70x105 4->320 conv_in no stats', 1, 70, 105, 4, 320, False, False, False, 0, False, 0, 0),
    ('unet 70x105 320->4 conv_out no stats', 1, 70, 105, 320, 4, True, False, False, 0, False, 0, 0),
    ('unet 70x105 320->320 skip 640', 1, 70, 105, 320, 320, True, False, False, 640, True, 0, 0),
    ('unet 70x105 320->320 skip 960', 1, 70, 105, 320, 320, True, False, False, 960, True, 0, 0),
    ('unet 70x105 320->320 res', 1, 70, 105, 320, 320, True, False, True, 0, True, 0, 0),
    ('unet 70x105 320->320 eb', 1, 70, 105, 320, 320, True, True, False, 0, True, 0, 0),
    ('unet 70x105 640->320 eb', 1, 70, 105, 640, 320, True, True, False, 0, True, 0, 0),
    ('unet 70x105 960->320 eb', 1, 70, 105, 960, 320, True, True, False, 0, True, 0, 0),
    ('unet 35x53 320->640 eb', 1, 35, 53, 320, 640, True, True, False, 0, True, 0, 0),
    ('unet 35x53 640->640 skip 320', 1, 35, 53, 640, 640, True, False, False, 320, True, 0, 0),
    ('unet 35x53 640->640 skip 960', 1, 35, 53, 640, 640, True, False, False, 960, True, 0, 0),
    ('unet 35x53 640->640 skip 1280', 1, 35, 53, 640, 640, True, False, False, 1280, True, 0, 0),
    ('unet 35x53 640->640 skip 1920', 1, 35, 53, 640, 640, True, False, False, 1920, True, 0, 0),
    ('unet 35x53 640->640 res', 1, 35, 53, 640, 640, True, False, True, 0, True, 0, 0),
    ('unet 35x53 640->640 eb', 1, 35, 53, 640, 640, True, True, False, 0, True, 0, 0),
    ('unet 35x53 960->640 eb', 1, 35, 53, 960, 640, True, True, False, 0, True, 0, 0),
    ('unet 35x53 1280->640 eb', 1, 35, 53, 1280, 640, True, True, False, 0, True, 0, 0),
    ('unet 35x53 1920->640 eb', 1, 35, 53, 1920, 640, True, True, False, 0, True, 0, 0),
    ('unet 18x27 640->1280 eb', 1, 18, 27, 640, 1280, True, True, False, 0, True, 0, 0),
    ('unet 18x27 1280->1280 skip 640', 1, 18, 27, 1280, 1280, True, False, False, 640, True, 0, 0),
    ('unet 18x27 1280->1280 skip 1920', 1, 18, 27, 1280, 1280, True, False, False, 1920, True, 0, 0),
    ('unet 18x27 1280->1280 skip 2560', 1, 18, 27, 1280, 1280, True, False, False, 2560, True, 0, 0),
    ('unet 18x27 1280->1280 res', 1, 18, 27, 1280, 1280, True, False, True, 0, True, 0, 0),
    ('unet 18x27 1280->1280 eb', 1, 18, 27, 1280, 1280, True, True, False, 0, True, 0, 0),
    ('unet 18x27 1920->1280 eb', 1, 18, 27, 1920, 1280, True, True, False, 0, True, 0, 0),
    ('unet 18x27 2560->1280 eb', 1, 18, 27, 2560, 1280, True, True, False, 0, True, 0, 0),
    ('unet 9x14 1280->1280 skip 2560', 1, 9, 14, 1280, 1280, True, False, False, 2560, True, 0, 0),
    ('unet 9x14 1280->1280 res no stats', 1, 9, 14, 1280, 1280, True, False, True, 0, False, 0, 0),
    ('unet 9x14 1280->1280 res', 1, 9, 14, 1280, 1280, True, False, True, 0, True, 0, 0),
    ('unet 9x14 1280->1280 eb', 1, 9, 14, 1280, 1280, True, True, False, 0, True, 0, 0),
    ('unet 9x14 2560->1280 eb', 1, 9, 14, 2560, 1280, True, True, False, 0, True, 0, 0)]
K1_PATH_CASES = len(K1_CASES)  # the rows before are the paths' shapes
# K4: every upsample of those paths, at its low-resolution input: (case, B,
# H, W, C, Co, Csk, stats, launches per request, per step)
K4_CASES = [
    ('vae 256x256 256->256 skip 128', 1, 256, 256, 256, 256, 128, True, 1, 2),
    ('vae 128x128 512->512 skip 128', 1, 128, 128, 512, 512, 128, True, 1, 2),
    ('vae 64x64 512->512 skip 256', 1, 64, 64, 512, 512, 256, True, 1, 2),
    ('unet 32x32 640->640 no stats', 1, 32, 32, 640, 640, 0, False, 1, 4),
    ('unet 16x16 1280->1280 no stats', 1, 16, 16, 1280, 1280, 0, False, 1, 4),
    ('unet 8x8 1280->1280 no stats', 1, 8, 8, 1280, 1280, 0, False, 1, 4),
    ('vae 280x420 256->256 skip 128', 1, 280, 420, 256, 256, 128, True, 0, 0),
    ('vae 140x210 512->512 skip 128', 1, 140, 210, 512, 512, 128, True, 0, 0),
    ('vae 70x105 512->512 skip 256', 1, 70, 105, 512, 512, 256, True, 0, 0)]
# K5 with its combine: (case, x shape)
K5_CASES = [
    ("unet 64^2x320", (1, 64, 64, 320)),
    ("unet concat 8^2x2560", (1, 8, 8, 2560)),
    ("vae 256^2x256", (1, 256, 256, 256)),
    ("ragged 105x70x640", (1, 105, 70, 640))]
# Every stride-2 downsample at 512x512 (VAE pad_lo=0 with stats, UNet
# pad_lo=1 without) and at 840x560, whose sizes are odd, with its launches
# in one 512x512 request and one train step (each VAE shape once a pass,
# each UNet shape twice: the forward and its recomputation; chip_smoke.py
# fails if a path counts others), and one shape no path runs, at which the
# kernel takes the 32 x 8 tile with a split (so that every form of it runs
# on the card): (case, B, H, W, C = Co, pad_lo, emits stats on its path,
# launches per request, per step)
K6_CASES = [
    ("vae 512^2x128 pad0", 1, 512, 512, 128, 0, True, 1, 2),
    ("vae 256^2x256 pad0", 1, 256, 256, 256, 0, True, 1, 2),
    ("vae 128^2x512 pad0", 1, 128, 128, 512, 0, True, 1, 2),
    ("unet 64^2x320 pad1", 1, 64, 64, 320, 1, False, 1, 4),
    ("unet 32^2x640 pad1", 1, 32, 32, 640, 1, False, 1, 4),
    ("unet 16^2x1280 pad1", 1, 16, 16, 1280, 1, False, 1, 4),
    ("vae 560x840x128 pad0", 1, 560, 840, 128, 0, True, 0, 0),
    ("unet 70x105x320 pad1", 1, 70, 105, 320, 1, False, 0, 0),
    ("unet 35x53x640 pad1", 1, 35, 53, 640, 1, False, 0, 0),
    ("unet 18x27x1280 pad1", 1, 18, 27, 1280, 1, False, 0, 0),
    ("32x8 split 128x64x640 pad1", 1, 128, 64, 640, 1, False, 0, 0)]
K6_PATH_CASES = 10  # the rows before are the paths' shapes
# K7: every attention shape of the paired step at 512x512, the UNet's self-
# and cross-attention at each level (hd 64) and the VAE mid attention (hd
# 512), with its launches in one train step (the UNet's 5 transformers at
# each of 64^2, 32^2 and 16^2 and its mid one, the VAE's encoder and decoder
# mid attention, in both generator passes): (case, B, Sq, Skv, H, hd,
# launches per step)
K7_CASES = [
    ("unet self S=4096 H=5", 1, 4096, 4096, 5, 64, 10),
    ("unet cross S=4096 Skv=77 H=5", 1, 4096, 77, 5, 64, 10),
    ("unet self S=1024 H=10", 1, 1024, 1024, 10, 64, 10),
    ("unet cross S=1024 Skv=77 H=10", 1, 1024, 77, 10, 64, 10),
    ("unet self S=256 H=20", 1, 256, 256, 20, 64, 10),
    ("unet cross S=256 Skv=77 H=20", 1, 256, 77, 20, 64, 10),
    ("unet mid self S=64 H=20", 1, 64, 64, 20, 64, 2),
    ("unet mid cross S=64 Skv=77 H=20", 1, 64, 77, 20, 64, 2),
    ("vae mid hd=512 S=4096", 1, 4096, 4096, 1, 512, 4)]


# The unpaired (CycleGAN-Turbo) step at 256x256 runs every shape of the
# paired step at 512x512 with its height and width halved (the UNet's
# latent 32x32, its deepest level 4x4; S a quarter; the cross-attention's
# 77 context rows unchanged), four times as often: eight generator
# forwards, each with its backward, where the paired step runs two
# (chip_smoke.py EXPECTED_UNPAIRED_LAUNCHES; it fails if the step counts
# other shapes). Each table keeps its paired table's columns up to the
# launches, then the launches per unpaired step.
UNPAIRED_PER_PAIRED = 4


def _halved(name: str) -> str:
    """A case name at the halved size: H^2 or else the first HxW halved,
    S quartered."""
    if "^2" in name:
        name = re.sub(r"(\d+)\^2", lambda m: f"{int(m[1]) // 2}^2", name)
    else:
        name = re.sub(r"(\d+)x(\d+)",
                      lambda m: f"{int(m[1]) // 2}x{int(m[2]) // 2}", name,
                      count=1)
    return re.sub(r"\bS=(\d+)", lambda m: f"S={int(m[1]) // 4}", name)


K1_UNPAIRED = [(_halved(c[0]), c[1], c[2] // 2, c[3] // 2, *c[4:11],
                UNPAIRED_PER_PAIRED * c[12]) for c in K1_CASES if c[12]]
K4_UNPAIRED = [(_halved(c[0]), c[1], c[2] // 2, c[3] // 2, *c[4:8],
                UNPAIRED_PER_PAIRED * c[9]) for c in K4_CASES if c[9]]
K6_UNPAIRED = [(_halved(c[0]), c[1], c[2] // 2, c[3] // 2, *c[4:7],
                UNPAIRED_PER_PAIRED * c[8]) for c in K6_CASES if c[8]]
DU_UNPAIRED = [(_halved(c[0]), c[1], c[2] // 2, c[3] // 2, *c[4:6],
                UNPAIRED_PER_PAIRED * c[6]) for c in DU_CASES if c[6]]
K7_UNPAIRED = [(_halved(c[0]), c[1], c[2] // 4,
                c[3] if c[3] == 77 else c[3] // 4, *c[4:6],
                UNPAIRED_PER_PAIRED * c[6]) for c in K7_CASES]
# K5 with its combine at two of the unpaired step's GroupNorm inputs: the
# UNet's deepest skip concat (16 rows, under one tile) and a VAE level
K5_UNPAIRED_CASES = [
    ("unet concat 4^2x2560", (1, 4, 4, 2560)),
    ("vae 128^2x256", (1, 128, 128, 256))]
# K3 at the unpaired step's transformer rows (32^2, 16^2, 8^2 and 4^2
# latents) and VAE mid attention (32^2); its launches are counted by shape
# in the run
K3_UNPAIRED_SHAPES = sorted(set(
    [s for m, c in ((1024, 320), (256, 640), (64, 1280), (16, 1280))
     for s in k3_shapes(m, c)] + K3_KV_SHAPES + k3_vae_shapes(1024)),
    key=lambda s: (-s[0], s))


def k3_name(shape) -> str:
    m, c, co, n, ln, gate, res = shape
    what = ("geglu " if gate else "") + ("ln " if ln else "") \
        + ("out+res " if res else "")
    return f"{what}{m}x{c}->{co}" + (f" x{n}" if n > 1 else "")


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def one_call_ms(fn, iters: int = 10) -> float:
    """fn()'s time between two CUDA events, host time included: the median
    of `iters` calls after a warm-up."""
    import torch
    fn()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return _median(times)


def device_ms(fn, calls: int = 20, replays: int = 5):
    """fn()'s device time alone: `calls` calls captured in one CUDA graph,
    replayed between two events, per call, the median of `replays`
    replays. Where the calls cannot be captured (autograd's backward), the
    device time of the kernels they launch under torch.profiler
    (`kernel_ms`), with the reason on stderr."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    try:
        # relaxed: a version may call the driver (an attribute set) inside
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            for _ in range(calls):
                fn()
    except RuntimeError as err:
        print(f"no CUDA graph ({str(err).splitlines()[0]}): device time "
              f"from torch.profiler", file=sys.stderr)
        torch.cuda.synchronize()
        return kernel_ms(fn, calls)
    g.replay()
    times = []
    for _ in range(replays):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / calls)
    return _median(times)


def kernel_ms(fn, calls: int = 20):
    """The device time of the kernels `calls` calls of fn() launch, summed
    under torch.profiler, per call (no gaps between kernels); None if the
    profiler saw no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / calls / 1e3 if us > 0 else None


def host_us(fn, iters: int = 50) -> float:
    """The host time of one call of fn(), in us: the mean over `iters` calls
    issued back to back (the card runs them behind), then one sync."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def _k3_call(fused_matmul, rn, shape):
    """A call of this checkout's K3 at `shape` on seeded inputs."""
    import torch
    m, c, co, n, ln, gate, res = shape
    wr = 2 * co if gate else co
    x = rn(1, m, c)
    ws = tuple(rn(wr, c) for _ in range(n))
    bs = tuple(rn(wr).float() for _ in range(n))
    lnp = (rn(c).float(), rn(c).float()) if ln else None
    r = rn(1, m, co) if res else None
    try:
        fused_matmul.fused(x, ws, bs, ln=lnp, residual=r, gate=gate)
    except ValueError:  # a checkout whose K3 takes (C, Co) weights
        ws = tuple(w.t().contiguous() for w in ws)
    torch.cuda.synchronize()
    return lambda: fused_matmul.fused(x, ws, bs, ln=lnp, residual=r,
                                      gate=gate)


def k1_inputs(rn, b, h, w, c, co, norm, has_eb, has_res, csk):
    """Seeded inputs of a K1 case: x, the HWIO weight, bias, GN (a, b),
    extra bias, residual, skip_x and skip_w (None where the case has
    none)."""
    x = rn(b, h, w, c)
    wt = rn(3, 3, c, co) / math.sqrt(9 * c)
    bias = rn(co).float()
    ga = gb = eb = res = skx = skw = None
    if norm:
        ga, gb = 1 + 0.1 * rn(b, c).float(), 0.1 * rn(b, c).float()
    if has_eb:
        eb = rn(b, co).float()
    if has_res:
        res = rn(b, h, w, co)
    if csk:
        skx, skw = rn(b, h, w, csk), rn(csk, co) / math.sqrt(csk)
    return x, wt, bias, ga, gb, eb, res, skx, skw


def conv_alone(x, wt, ga=None, gb=None):
    """The library's share of a K1 case: cuDNN's F.conv2d (channels_last,
    no bias) on the input activated beforehand, which is not the function
    K1 computes (no prologue, bias, skip, residual or stats). Returns a
    call."""
    import torch
    import torch.nn.functional as F
    h = x
    if ga is not None:
        h = F.silu(x.float() * ga[:, None, None, :] + gb[:, None, None, :]
                   ).to(x.dtype)
    hc = h.permute(0, 3, 1, 2)              # NCHW view of NHWC memory
    wc = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(hc, wc, padding=1)


def _k1_call(rn, b, h, w, c, co, norm, has_eb, has_res, csk, stats,
             *_launches):
    from img2img_turbo_tpu_torch.ops import fused_conv as fc
    x, wt, bias, ga, gb, eb, res, skx, skw = k1_inputs(
        rn, b, h, w, c, co, norm, has_eb, has_res, csk)
    wp = fc.pack_weights(wt)
    skwp = None if skw is None else fc.pack_weights(skw)
    return lambda: fc.fused_gn_silu_conv3x3(
        x, wt, bias, ga, gb, eb, res, skx, skw, emit_stats=stats,
        w_packed=wp, skip_w_packed=skwp)


def _k4_call(rn, b, h, w, c, co, csk, stats, *_launches):
    from img2img_turbo_tpu_torch.ops import fused_conv as fc
    x = rn(b, h, w, c)
    wt = rn(3, 3, c, co) / math.sqrt(9 * c)
    bias = rn(co).float()
    skx = skw = skwp = None
    if csk:
        skx, skw = rn(b, 2 * h, 2 * w, csk), rn(csk, co) / math.sqrt(csk)
        skwp = fc.pack_weights(skw)
    wp = fc.pack_weights(fc.fold_upsample_weights(wt))
    return lambda: fc.upsample2x_conv3x3(x, wt, bias, skx, skw,
                                         emit_stats=stats, w_packed=wp,
                                         skip_w_packed=skwp)


def _k5_call(rn, shape):
    from img2img_turbo_tpu_torch.ops import groupnorm as gn
    x = rn(*shape) * 2 + 0.5
    scale, bias = 1 + 0.1 * rn(shape[-1]).float(), 0.1 * rn(shape[-1]).float()
    return lambda: gn.group_norm_coeffs(x, scale, bias, 32, 1e-5)


def _k6_call(rn, b, h, w, c, pad_lo, stats, *_launches):
    from img2img_turbo_tpu_torch.ops import fused_conv as fc
    x = rn(b, h, w, c)
    wt = rn(3, 3, c, c) / math.sqrt(9 * c)
    bias = rn(c).float()
    wp = fc.pack_weights(wt)
    return lambda: fc.downsample2x_conv3x3(x, wt, bias, pad_lo,
                                           emit_stats=stats, w_packed=wp)


def sdpa(q, k, v, num_heads=None):
    """F.scaled_dot_product_attention on the folded (B, S, H*hd) tensors'
    head views (the library yardstick of K2 and, differentiated, of K7),
    or with num_heads None on (B, H, S, d) tensors as they are (K9's).
    Returns (the backend's name, a call that runs SDPA on it and returns
    the (B, H, Sq, hd) output): flash, then memory-efficient, then cuDNN,
    then math, the first that takes the shapes."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def heads(t):
        if num_heads is None:
            return t
        b, s, d = t.shape
        return t.view(b, s, num_heads, d // num_heads).transpose(1, 2)

    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(heads(q), heads(k),
                                                      heads(v))
        try:
            with warnings.catch_warnings():  # the refusals of the others
                warnings.simplefilter("ignore")
                call()
        except RuntimeError:
            continue
        return backend.name.lower(), call
    raise RuntimeError("no SDPA backend took the shapes")


def sdpa_backward(q, k, v, do, num_heads):
    """The backward of `sdpa` on folded (B, S, H*hd) tensors with output
    cotangent do: (the backend's name, a call of autograd's gradient of
    q, k and v)."""
    import torch
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    backend, call = sdpa(qg, kg, vg, num_heads)
    out = call()
    b, sq, d = do.shape
    do_h = do.view(b, sq, num_heads, d // num_heads).transpose(1, 2)
    return backend, lambda: torch.autograd.grad(out, (qg, kg, vg), do_h,
                                                retain_graph=True)


def _k7_inputs(rn, b, sq, skv, h, hd):
    from img2img_turbo_tpu_torch.ops import attention
    q, k, v = (rn(b, s, h * hd) for s in (sq, skv, skv))
    do = rn(b, sq, h * hd)
    o, lse = attention.flash_attention_folded(q, k, v, h, return_lse=True)
    return q, k, v, o, do, lse


def _k7_call(rn, b, sq, skv, h, hd, *_launches):
    from img2img_turbo_tpu_torch.ops import attention
    q, k, v, o, do, lse = _k7_inputs(rn, b, sq, skv, h, hd)
    return lambda: attention.flash_attention_folded_bwd(q, k, v, o, do, lse,
                                                        h)


def _du_call(rn, b, h, w, c, co, _launches):
    """A call of this checkout's K8 du on seeded inputs."""
    from img2img_turbo_tpu_torch.models import layers
    from img2img_turbo_tpu_torch.ops import fused_conv
    gy = rn(b, h, w, co)
    wt = rn(co, c, 3, 3) / math.sqrt(9 * c)          # nn.Conv2d's layout
    new = getattr(fused_conv, "conv3x3_input_grad", None)
    if new is not None and len(inspect.signature(new).parameters) == 3:
        wp = fused_conv.pack_weights(wt.permute(2, 3, 1, 0).contiguous())
        return lambda: new(gy, wp, c)
    return lambda: layers.conv3x3_input_grad(gy, wt)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--only", default="K1,K2,K3,K4,K5,K6,K7,K9,du",
                   help="comma-separated kernels to time (K1, K2, K3, K4, "
                   "K5, K6, K7, K9, du)")
    only = set(p.parse_args().only.split(","))
    sys.path.insert(0, os.getcwd())
    import torch
    from img2img_turbo_tpu_torch.ops import attention, fused_matmul

    if not torch.cuda.is_available():
        sys.exit("time_kernels: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    def report(kernel, case, fn):
        r = {"kernel": kernel, "case": case, "ms": one_call_ms(fn),
             "device_ms": device_ms(fn), "host_us": host_us(fn)}
        print(json.dumps(r), flush=True)
        return r

    def weighted(kernel, what, rows, launches):
        """A kernel's times summed over its cases, each times its launches
        on a path (None where a case has no time)."""
        out = {"kernel": kernel, "case": what, "launches": sum(launches)}
        for key in ("ms", "device_ms", "library_device_ms",
                    "conv_alone_device_ms"):
            if key in rows[0]:
                vals = [r[key] for r in rows]
                out[key] = (None if None in vals else
                            sum(n * v for n, v in zip(launches, vals)))
        print(json.dumps(out), flush=True)

    cases = {"K1": (K1_CASES, _k1_call), "K4": (K4_CASES, _k4_call),
             "K5": (K5_CASES, _k5_call), "K6": (K6_CASES, _k6_call),
             "K7": (K7_CASES, _k7_call)}
    for kernel, (table, make) in cases.items():
        if kernel not in only:
            continue
        rows = [report(kernel, case, make(rn, *dims)) for case, *dims in table]
        if kernel == "K1":
            # cuDNN's conv alone on the activated input (not K1's function)
            for r, (case, *dims) in zip(rows, table):
                x, wt, _, ga, gb, *_ = k1_inputs(rn, *dims[:9])
                r["conv_alone_device_ms"] = device_ms(conv_alone(x, wt, ga,
                                                                 gb))
                print(json.dumps({"kernel": "K1", "case": case,
                                  "conv_alone_device_ms":
                                  r["conv_alone_device_ms"]}), flush=True)
        if kernel in ("K1", "K4", "K6"):
            # per 512x512 request and per train step
            for col, what in ((-2, "per 512x512 request"),
                              (-1, "per train step")):
                weighted(kernel, what, rows, [c[col] for c in table])
        if kernel == "K7":
            # the library's backward on the same inputs, then both per
            # train step at each head dim
            for r, (case, *dims) in zip(rows, table):
                backend, call = sdpa_backward(*_k7_inputs(rn, *dims[:5])[:3],
                                              rn(dims[0], dims[1],
                                                 dims[3] * dims[4]), dims[3])
                r["library"] = f"sdpa[{backend}] backward"
                r["library_device_ms"] = device_ms(call)
                print(json.dumps({"kernel": "K7", "case": case,
                                  "library": r["library"],
                                  "library_device_ms":
                                  r["library_device_ms"]}), flush=True)
            for hd in sorted({c[5] for c in table}):
                pick = [i for i, c in enumerate(table) if c[5] == hd]
                weighted("K7", f"per train step, hd {hd}",
                         [rows[i] for i in pick], [table[i][-1] for i in pick])
    for kernel, case, b, sq, skv, h, hd in ATTENTION_CASES:
        if kernel not in only:
            continue
        if kernel == "K2":
            q, k, v = rn(b, sq, h * hd), rn(b, skv, h * hd), rn(b, skv, h * hd)
            report(kernel, case, lambda: attention.flash_attention_folded(
                q, k, v, h, return_lse=True))
        else:
            q, k, v = rn(b, h, sq, hd), rn(b, h, skv, hd), rn(b, h, skv, hd)
            report(kernel, case, lambda: attention.flash_attention(q, k, v))
    if "K3" in only:
        for shape in K3_SHAPES:
            report("K3", k3_name(shape), _k3_call(fused_matmul, rn, shape))
    if "du" in only:
        step = {"ms": 0.0, "device_ms": 0.0}
        for case, *dims in DU_CASES:
            r = report("du", case, _du_call(rn, *dims))
            for key in step:
                step[key] = (None if step[key] is None or r[key] is None
                             else step[key] + dims[-1] * r[key])
        # the du's time in one train step, each case weighted by its launches
        print(json.dumps({"kernel": "du", "case": "per train step",
                          "launches": sum(c[-1] for c in DU_CASES), **step}),
              flush=True)


if __name__ == "__main__":
    main()
