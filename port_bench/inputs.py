"""Synthetic photographs from the seed: smooth colour fields with sharp
rectangles and discs of random colour and a little sensor noise, so that
canny finds edges at its published thresholds and every image of a pool
differs. Made on the device in whole batches, then held on the host as the
uint8 (N, H, W, 3) arrays a client would send."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.weights import generator


SHAPES = 24      # rectangles and discs an image


def image_pool(seed: int, n: int, height: int, width: int,
               device) -> np.ndarray:
    g = generator(seed, "images", device)

    def rand(*s):
        return torch.rand(s, generator=g, device=device)

    img = F.interpolate(rand(n, 3, 6, 10), size=(height, width),
                        mode="bicubic", align_corners=False) * 160 + 48
    yy = torch.arange(height, device=device).view(1, 1, height, 1) / height
    xx = torch.arange(width, device=device).view(1, 1, 1, width) / width
    for k in range(SHAPES):
        y0, x0 = rand(n, 1, 1, 1), rand(n, 1, 1, 1)
        hh, ww = 0.03 + 0.3 * rand(n, 1, 1, 1), 0.03 + 0.3 * rand(n, 1, 1, 1)
        if k % 2:
            mask = ((yy - y0) / hh) ** 2 + ((xx - x0) / ww) ** 2 < 1
        else:
            mask = (yy >= y0) & (yy < y0 + hh) & (xx >= x0) & (xx < x0 + ww)
        img = torch.where(mask, rand(n, 3, 1, 1) * 255, img)
    img = img + torch.randn(img.shape, generator=g, device=device) * 4
    out = img.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)
    return out.contiguous().cpu().numpy()
