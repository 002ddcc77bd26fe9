"""cv2.Canny-equivalent edge detection as plain torch ops (counterpart of
`img2img_turbo_tpu.ops.canny`; the JAX version has no Pallas kernel either).
Hysteresis runs on 0/1 float maps, one max-pool and one multiply per step.

3x3 Sobel with REFLECT_101 borders (torch's `mode="reflect"`), L1 gradient
magnitude, per-pixel max-magnitude channel (strict `>`: ties keep the lower
channel), tan(22.5)/tan(67.5) binned non-maximum suppression, double
threshold and exactly `hysteresis_iters` 8-neighbour dilation steps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _sobel_all_channels(x):
    """x: (B, H, W, C) float32 -> (gx, gy), each (B, C, H, W)."""
    xc = x.permute(0, 3, 1, 2)
    xp = F.pad(xc, (1, 1, 1, 1), mode="reflect")
    h, w = x.shape[1], x.shape[2]

    def s(dy, dx):
        return xp[:, :, dy:dy + h, dx:dx + w]

    gx = (s(0, 2) - s(0, 0)) + 2.0 * (s(1, 2) - s(1, 0)) \
        + (s(2, 2) - s(2, 0))
    gy = (s(2, 0) - s(0, 0)) + 2.0 * (s(2, 1) - s(0, 1)) \
        + (s(2, 2) - s(0, 2))
    return gx, gy


def _shift(x, dy: int, dx: int):
    """Zero-padded shift: out[y, x] = in[y+dy, x+dx]; x: (B, H, W)."""
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x, (1, 1, 1, 1))
    return xp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _dilate8(m):
    """8-connected binary dilation of a (B, H, W) 0/1 float map: a 3x3 max
    pool, whose implicit -inf padding leaves the border as a zero-padded OR
    of shifts would (the JAX version's `_dilate8`)."""
    return F.max_pool2d(m[:, None], 3, stride=1, padding=1)[:, 0]


def canny(image_u8, low_threshold: float = 100.0,
          high_threshold: float = 200.0, hysteresis_iters: int = 32):
    """image_u8: (B, H, W, C) uint8 -> (B, H, W) uint8 edge map in {0, 255}."""
    x = image_u8.float()
    gx_c, gy_c = _sobel_all_channels(x)
    mag_c = gx_c.abs() + gy_c.abs()
    gx, gy, mag = gx_c[:, 0], gy_c[:, 0], mag_c[:, 0]
    for ch in range(1, x.shape[-1]):
        take = mag_c[:, ch] > mag
        gx = torch.where(take, gx_c[:, ch], gx)
        gy = torch.where(take, gy_c[:, ch], gy)
        mag = torch.where(take, mag_c[:, ch], mag)

    ax, ay = gx.abs(), gy.abs()
    tg22 = 0.4142135623730951
    tg67 = 2.414213562373095
    horiz = ay < ax * tg22
    vert = ay > ax * tg67
    same_sign = (gx * gy) >= 0

    keep_h = (mag > _shift(mag, 0, -1)) & (mag >= _shift(mag, 0, 1))
    keep_v = (mag > _shift(mag, -1, 0)) & (mag >= _shift(mag, 1, 0))
    keep_d1 = (mag > _shift(mag, -1, -1)) & (mag >= _shift(mag, 1, 1))
    keep_d2 = (mag > _shift(mag, -1, 1)) & (mag >= _shift(mag, 1, -1))
    keep = torch.where(horiz, keep_h,
                       torch.where(vert, keep_v,
                                   torch.where(same_sign, keep_d1, keep_d2)))

    strong = (keep & (mag > high_threshold)).float()
    weak = (keep & (mag > low_threshold)).float()
    edges = strong
    for _ in range(hysteresis_iters):
        edges = torch.maximum(edges, weak * _dilate8(edges))
    return edges.to(torch.uint8) * 255


def canny_3ch_unit(image_u8, low_threshold: float = 100.0,
                   high_threshold: float = 200.0):
    """3-channel replicated edge map in [0, 1] float32, (B, H, W, 3)."""
    e = canny(image_u8, low_threshold, high_threshold).float() / 255.0
    return e[..., None].expand(*e.shape, 3).contiguous()
