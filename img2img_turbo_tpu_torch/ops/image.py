"""dtype / range conversions on the device (counterpart of
`img2img_turbo_tpu.ops.image`, lines 22-39)."""

from __future__ import annotations

import torch


def uint8_to_unit(x):
    """uint8 [0,255] -> float32 [0,1]."""
    return x.float() / 255.0


def uint8_to_signed(x):
    """uint8 [0,255] -> float32 [-1,1] (transforms.Normalize(0.5, 0.5))."""
    return x.float() / 127.5 - 1.0


def signed_to_uint8(x):
    """float [-1,1] -> uint8, matching ToPILImage(out*0.5+0.5) rounding.
    torch.round rounds half to even, as jnp.round does."""
    y = (torch.clamp(x, -1.0, 1.0) * 0.5 + 0.5) * 255.0
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
