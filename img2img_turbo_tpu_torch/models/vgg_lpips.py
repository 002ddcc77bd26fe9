"""VGG16 + LPIPS perceptual distance, written by hand (no torchvision), the
counterpart of `img2img_turbo_tpu/models/vgg_lpips.py`: inputs in [-1, 1],
LPIPS shift/scale, VGG16 features at relu1_2 / 2_2 / 3_3 / 4_3 / 5_3,
channel-unit normalisation, 1x1 linear heads, spatial mean, summed over
the five layers. NHWC activations; convolutions run in the input's dtype
(weights cast at use), as the JAX package's XLA convs do.
`load_lpips_weights` reads the `lpips` package's VGG file
(vgg_lpips.py:106-154).
"""

from __future__ import annotations

from typing import Dict

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


# torchvision vgg16.features indices of each block's convs
VGG_FEATURE_INDICES = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21),
                       (24, 26, 28))


def convert_lpips_state_dict(vgg_sd: Dict[str, torch.Tensor],
                             lin_sd: Dict[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
    """A torchvision vgg16.features state dict ("features.<i>.weight") and
    the LPIPS heads ("lin<i>.model.1.weight", (1, C, 1, 1)) -> VGGLPIPS's
    state dict."""
    out: Dict[str, torch.Tensor] = {}
    for b, idxs in enumerate(VGG_FEATURE_INDICES):
        for j, i in enumerate(idxs):
            for field in ("weight", "bias"):
                out[f"blocks.{b}.{j}.{field}"] = vgg_sd[f"features.{i}.{field}"]
    for i in range(len(VGG_FEATURE_INDICES)):
        out[f"lins.{i}.weight"] = lin_sd[f"lin{i}.model.1.weight"]
    return out


def load_lpips_weights(path: str) -> Dict[str, torch.Tensor]:
    """VGGLPIPS's state dict from one torch file: an
    `lpips.LPIPS(net="vgg")` state dict ("net.slice<k>.<i>.weight" and
    "lin<i>.model.1.weight"), or {"vgg": torchvision features state dict,
    "lins": the heads}."""
    from img2img_turbo_tpu_torch.weights.torch_import import load_torch_pickle
    sd = load_torch_pickle(path)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and "vgg" in sd and "lins" in sd:
        return convert_lpips_state_dict(sd["vgg"], sd["lins"])
    vgg_sd, lin_sd = {}, {}
    for k, v in sd.items():
        if k.startswith("net.slice"):
            # lpips names a slice's convs by their torchvision index
            vgg_sd["features." + k.split(".", 2)[2]] = v
        elif k.startswith("lin"):
            lin_sd[k] = v
        elif k.startswith("features."):
            vgg_sd[k] = v
    if not lin_sd:
        raise ValueError(f"{path}: no lpips lin-head weights found "
                         "(expected 'linN.model.1.weight' keys)")
    return convert_lpips_state_dict(vgg_sd, lin_sd)
