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


def _torch_resize_matrix(in_size: int, out_size: int, mode: str):
    """(out, in) float64 numpy matrix of torch's F.interpolate(mode,
    align_corners=False) without antialias: half-pixel source centres,
    fixed-width taps on a downscale too, border taps clamped; bicubic is
    cubic convolution with a = -0.75 (`image.py:_torch_resize_matrix`)."""
    import numpy as np
    centers = (np.arange(out_size, dtype=np.float64) + 0.5) \
        * (in_size / out_size) - 0.5
    base = np.floor(centers).astype(np.int64)
    rows = np.arange(out_size)
    w = np.zeros((out_size, in_size), np.float64)
    if mode == "bilinear":
        frac = centers - base
        taps = ((base, 1.0 - frac), (base + 1, frac))
    elif mode == "bicubic":
        a = -0.75

        def k(t):
            t = np.abs(t)
            return np.where(
                t <= 1.0, ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0,
                np.where(t < 2.0, (((t - 5.0) * t + 8.0) * t - 4.0) * a, 0.0))

        taps = tuple((base + j, k(centers - (base + j))) for j in range(-1, 3))
    else:
        raise ValueError(f"unknown resize mode {mode!r}")
    for tap, wgt in taps:
        np.add.at(w, (rows, np.clip(tap, 0, in_size - 1)), wgt)
    return w


def resize_torch(x, height: int, width: int, mode: str = "bicubic"):
    """NHWC resize with torch F.interpolate(align_corners=False) numerics,
    no antialias, as two dense products in x's dtype (the counterpart of
    `image.py:resize_torch`, which the discriminator and CLIP-sim losses
    use). Differentiable, with a deterministic backward."""
    h, w = x.shape[1:3]
    wh = torch.as_tensor(_torch_resize_matrix(h, height, mode),
                         dtype=torch.float32).to(x.device, x.dtype)
    ww = torch.as_tensor(_torch_resize_matrix(w, width, mode),
                         dtype=torch.float32).to(x.device, x.dtype)
    y = torch.einsum("Oh,bhwc->bOwc", wh, x)
    return torch.einsum("Ww,bhwc->bhWc", ww, y)
