"""VGG16 + LPIPS perceptual distance, written by hand (no torchvision), the
counterpart of `img2img_turbo_tpu/models/vgg_lpips.py`: inputs in [-1, 1],
LPIPS shift/scale, VGG16 features at relu1_2 / 2_2 / 3_3 / 4_3 / 5_3,
channel-unit normalisation, 1x1 linear heads, spatial mean, summed over
the five layers. NHWC activations; convolutions run in the input's dtype
(weights cast at use), as the JAX package's XLA convs do.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from img2img_turbo_tpu_torch.models import layers as L

# VGG16 conv plan: (out_channels, layers) per block; max pool between blocks
VGG_PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def max_pool_2x2(x):
    """2x2 max pool, stride 2, floor mode, NHWC. Written as a reduction,
    so its backward is elementwise (deterministic on the card)."""
    b, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    return x[:, :2 * h2, :2 * w2].reshape(b, h2, 2, w2, 2, c).amax(dim=(2, 4))


class VGGLPIPS(nn.Module):
    """`blocks.{i}.{j}`: the 13 VGG16 convs; `lins.{i}`: the five 1x1
    bias-free LPIPS heads."""

    def __init__(self):
        super().__init__()
        blocks, lins = [], []
        in_ch = 3
        for out_ch, n in VGG_PLAN:
            convs = []
            for _ in range(n):
                convs.append(nn.Conv2d(in_ch, out_ch, 3))
                in_ch = out_ch
            blocks.append(nn.ModuleList(convs))
            lins.append(nn.Conv2d(out_ch, 1, 1, bias=False))
        self.blocks = nn.ModuleList(blocks)
        self.lins = nn.ModuleList(lins)

    def features(self, x):
        """x (B, H, W, 3) already LPIPS-normalised -> the five relu taps."""
        feats = []
        h = x
        for i, convs in enumerate(self.blocks):
            if i > 0:
                h = max_pool_2x2(h)
            for conv in convs:
                h = torch.relu(L.conv2d(conv, h))
            feats.append(h)
        return feats

    def forward(self, x, y):
        """LPIPS distance between x and y, (B, H, W, 3) in [-1, 1] -> (B,)
        fp32."""
        def norm_in(t):
            shift = torch.tensor(_SHIFT, device=t.device).to(t.dtype)
            scale = torch.tensor(_SCALE, device=t.device).to(t.dtype)
            return (t - shift) / scale

        def unit(f, eps=1e-10):
            n = f.float().square().sum(-1, keepdim=True).sqrt()
            return f / (n + eps).to(f.dtype)

        total = 0.0
        for f1, f2, lin in zip(self.features(norm_in(x)),
                               self.features(norm_in(y)), self.lins):
            d = (unit(f1) - unit(f2)).square()
            total = total + L.conv2d(lin, d.float()).mean(dim=(1, 2, 3))
        return total
