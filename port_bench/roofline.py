"""The card's published peaks and the least time each of the port's kernels
could take at a launch shape, as the port's launch counter keys them
(`ops/_build.launch_shapes`). The least time is the larger of operations
over the bf16 tensor-core peak and bytes over the memory peak; each input
byte is counted once and each output byte once, at the least the call
needs (weights unpadded, GroupNorm statistics as one sum and one sum of
squares a channel). The operation counts are those the port's smoke test
used for K1, K4, K6, K8's du and K2.
"""

from __future__ import annotations

import re
from typing import Iterable, Tuple

# NVIDIA H100 SXM data sheet, dense, at the full 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

BF16, F32 = 2, 4


def _stats(b, co, on):
    return b * 2 * co * F32 if on else 0


def k1(B, H, W, C, Co, norm, eb, res, csk, stats):
    """fused_gn_silu_conv3x3: y = conv3x3(silu(x a + b)) + bias [+ eb]
    [+ skip_x skip_w] [+ residual]."""
    px = B * H * W
    flops = 2 * px * Co * (9 * C + csk)
    nbytes = (px * C * BF16 + 9 * C * Co * BF16 + Co * F32
              + (2 * B * C * F32 if norm else 0) + (B * Co * F32 if eb else 0)
              + (px * Co * BF16 if res else 0)
              + (px * csk * BF16 + csk * Co * BF16 if csk else 0)
              + px * Co * BF16 + _stats(B, Co, stats))
    return flops, nbytes


def k4(B, H, W, C, Co, csk, stats):
    """upsample2x_conv3x3 on its low-resolution input (B, H, W, C): four
    phases of 2x2 taps at each input pixel."""
    px = B * 4 * H * W
    flops = 2 * px * Co * (4 * C + csk)
    nbytes = (B * H * W * C * BF16 + 9 * C * Co * BF16 + Co * F32
              + (px * csk * BF16 + csk * Co * BF16 if csk else 0)
              + px * Co * BF16 + _stats(B, Co, stats))
    return flops, nbytes


def down_size(n, pad_lo):
    return (n + pad_lo + 1 - 3) // 2 + 1


def k6(B, H, W, C, Co, pad_lo):
    """downsample2x_conv3x3: stride-2 conv3x3 with ((pad_lo, 1), ...)."""
    ho, wo = down_size(H, pad_lo), down_size(W, pad_lo)
    flops = 2 * B * ho * wo * C * 9 * Co
    nbytes = (B * H * W * C * BF16 + 9 * C * Co * BF16 + Co * F32
              + B * ho * wo * Co * BF16)
    return flops, nbytes


def du(B, H, W, C, Co):
    """conv3x3_input_grad of a C -> Co conv at its output gradient."""
    flops = 2 * B * H * W * C * 9 * Co
    nbytes = B * H * W * (Co + C) * BF16 + 9 * C * Co * BF16
    return flops, nbytes


def k2(B, Sq, Skv, H, hd):
    """flash_attention_folded: Q K^T and P V."""
    flops = 4 * B * Sq * Skv * H * hd
    nbytes = 2 * B * (Sq + Skv) * H * hd * BF16
    return flops, nbytes


# launch-counter name -> (bound formula, kernel names in the device trace)
CONV = {"fused_gn_silu_conv3x3": k1, "upsample2x_conv3x3": k4,
        "downsample2x_conv3x3": k6}
CONV_TRAIN = dict(CONV, conv3x3_input_grad=du)
ATTN = {"flash_attention_folded": k2}
CONV_KERNELS = re.compile(r"\b(conv_kernel|conv_reduce|down_kernel|"
                          r"down_reduce)\b")
CONV_TRAIN_KERNELS = re.compile(r"\b(conv_kernel|conv_reduce|down_kernel|"
                                r"down_reduce|dgrad_kernel|dgrad_reduce)\b")
ATTN_KERNELS = re.compile(r"\bflash_kernel\b")


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def bound_total(shapes, formulas) -> Tuple[float, int]:
    """(seconds, launches) of the least time of every counted launch whose
    counter name has a formula; shapes: {(name, shape): count}."""
    total, n = 0.0, 0
    for (name, shape), count in shapes.items():
        f = formulas.get(name)
        if f is not None:
            total += count * bound_s(*f(*shape))
            n += count
    return total, n


def share_pct(shapes, formulas, kernels: Iterable, pattern) -> float:
    """The window's summed least time over its summed device time of the
    kernels whose names match `pattern`, in %; None when either is
    absent."""
    bound, n = bound_total(shapes, formulas)
    dev = sum(d for name, _, d in kernels if pattern.search(name))
    if not n or dev <= 0:
        return None
    return 100.0 * bound / dev
