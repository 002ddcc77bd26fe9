"""Plain cv2.Canny-style edge map in fp32 PyTorch (see PROVENANCE.md):
3x3 Sobel with reflect-101 borders, L1 magnitude, the channel of largest
magnitude (ties keep the lower channel), non-maximum suppression in four
bins at tan(22.5) and tan(67.5), double threshold, and `iters` steps of
8-neighbour hysteresis."""

from __future__ import annotations

import torch
import torch.nn.functional as F

TAN22 = 0.4142135623730951
TAN67 = 2.414213562373095


def _shift(x, dy, dx):
    """out[y, x] = in[y + dy, x + dx], zero outside; x (B, H, W)."""
    h, w = x.shape[1:]
    xp = F.pad(x, (1, 1, 1, 1))
    return xp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def canny(image_u8, low: float, high: float, iters: int = 32):
    """(B, H, W, C) uint8 -> (B, H, W) float32 edge map in {0, 1}."""
    x = F.pad(image_u8.float().permute(0, 3, 1, 2), (1, 1, 1, 1),
              mode="reflect")
    h, w = image_u8.shape[1:3]

    def s(dy, dx):
        return x[:, :, dy:dy + h, dx:dx + w]

    gx_c = (s(0, 2) - s(0, 0)) + 2 * (s(1, 2) - s(1, 0)) + (s(2, 2) - s(2, 0))
    gy_c = (s(2, 0) - s(0, 0)) + 2 * (s(2, 1) - s(0, 1)) + (s(2, 2) - s(0, 2))
    mag_c = gx_c.abs() + gy_c.abs()
    gx, gy, mag = gx_c[:, 0], gy_c[:, 0], mag_c[:, 0]
    for c in range(1, mag_c.shape[1]):
        take = mag_c[:, c] > mag
        gx = torch.where(take, gx_c[:, c], gx)
        gy = torch.where(take, gy_c[:, c], gy)
        mag = torch.where(take, mag_c[:, c], mag)
    ax, ay = gx.abs(), gy.abs()

    def peak(dy, dx):
        return (mag > _shift(mag, dy, dx)) & (mag >= _shift(mag, -dy, -dx))

    keep = torch.where(ay < ax * TAN22, peak(0, -1),
                       torch.where(ay > ax * TAN67, peak(-1, 0),
                                   torch.where(gx * gy >= 0, peak(-1, -1),
                                               peak(-1, 1))))
    weak = (keep & (mag > low)).float()
    edges = (keep & (mag > high)).float()
    for _ in range(iters):
        grown = F.max_pool2d(edges[:, None], 3, stride=1, padding=1)[:, 0]
        edges = torch.maximum(edges, weak * grown)
    return edges
