"""The FID InceptionV3 feature extractor (counterpart of
`img2img_turbo_tpu/metrics/inception.py`): BasicConv2d = conv + frozen
BatchNorm (eps 1e-3) folded into a per-channel `scale` and `bias` + ReLU,
Mixed_5b..7c, and the mean over H and W -> 2048 pool3 features.

The TF-ported FID model (pytorch-fid / clean-fid) differs from
torchvision's `inception_v3` in two ways, both kept under
`fid_variant=True`: every in-block 3x3 average pool divides by the real
window count at the borders (count_include_pad=False), and Mixed_7c's pool
branch is a max pool. `fid_variant=False` gives torchvision's pools.

The JAX package computes this network outside Pallas, so the port runs it
in plain PyTorch (cuDNN convs, PyTorch pools), NCHW inside, in fp32.
Parameter names follow the JAX tree: `<block>.<conv>.weight` (OIHW),
`.scale`, `.bias`. `convert_inception_state_dict` folds a torchvision
inception_v3 state dict into them; `random_inception` draws the JAX
package's init (kernels N(0, 1/fan_in), scale 1, bias 0).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

import torch
import torch.nn as nn
import torch.nn.functional as F


class BasicConv2d(nn.Module):
    """conv (no bias) with the batch norm folded into scale and bias, then
    ReLU (inception.py:45-63)."""

    def __init__(self, cin: int, cout: int, k, stride: int = 1, padding=0):
        super().__init__()
        k = (k, k) if isinstance(k, int) else tuple(k)
        self.stride = stride
        self.padding = (padding, padding) if isinstance(padding, int) \
            else tuple(padding)
        self.weight = nn.Parameter(torch.empty(cout, cin, *k))
        self.scale = nn.Parameter(torch.ones(cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        y = F.conv2d(x, self.weight.to(x.dtype), stride=self.stride,
                     padding=self.padding)
        y = y * self.scale.to(x.dtype)[:, None, None] \
            + self.bias.to(x.dtype)[:, None, None]
        return F.relu(y)


def _avgpool3(x):
    """3x3 stride-1 average pool, divided by the real window size at the
    borders (inception.py:70)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _maxpool(x):
    return F.max_pool2d(x, 3, 2)


def _maxpool3_same(x):
    return F.max_pool2d(x, 3, 1, 1)


def _block(spec: List[Tuple]) -> nn.ModuleDict:
    return nn.ModuleDict({name: BasicConv2d(*args) for name, *args in spec})


def _inception_a(cin, pool_features):
    return _block([
        ("branch1x1", cin, 64, 1), ("branch5x5_1", cin, 48, 1),
        ("branch5x5_2", 48, 64, 5, 1, 2), ("branch3x3dbl_1", cin, 64, 1),
        ("branch3x3dbl_2", 64, 96, 3, 1, 1),
        ("branch3x3dbl_3", 96, 96, 3, 1, 1),
        ("branch_pool", cin, pool_features, 1)])


def _inception_c(c7):
    row, col = (1, 7), (7, 1)
    prow, pcol = (0, 3), (3, 0)
    return _block([
        ("branch1x1", 768, 192, 1), ("branch7x7_1", 768, c7, 1),
        ("branch7x7_2", c7, c7, row, 1, prow),
        ("branch7x7_3", c7, 192, col, 1, pcol),
        ("branch7x7dbl_1", 768, c7, 1),
        ("branch7x7dbl_2", c7, c7, col, 1, pcol),
        ("branch7x7dbl_3", c7, c7, row, 1, prow),
        ("branch7x7dbl_4", c7, c7, col, 1, pcol),
        ("branch7x7dbl_5", c7, 192, row, 1, prow),
        ("branch_pool", 768, 192, 1)])


def _inception_e(cin):
    return _block([
        ("branch1x1", cin, 320, 1), ("branch3x3_1", cin, 384, 1),
        ("branch3x3_2a", 384, 384, (1, 3), 1, (0, 1)),
        ("branch3x3_2b", 384, 384, (3, 1), 1, (1, 0)),
        ("branch3x3dbl_1", cin, 448, 1),
        ("branch3x3dbl_2", 448, 384, 3, 1, 1),
        ("branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1)),
        ("branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0)),
        ("branch_pool", cin, 192, 1)])


class InceptionV3(nn.Module):
    FEATURES = 2048

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, 2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, 1, 1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = _inception_a(192, 32)
        self.Mixed_5c = _inception_a(256, 64)
        self.Mixed_5d = _inception_a(288, 64)
        self.Mixed_6a = _block([
            ("branch3x3", 288, 384, 3, 2), ("branch3x3dbl_1", 288, 64, 1),
            ("branch3x3dbl_2", 64, 96, 3, 1, 1),
            ("branch3x3dbl_3", 96, 96, 3, 2)])
        self.Mixed_6b = _inception_c(128)
        self.Mixed_6c = _inception_c(160)
        self.Mixed_6d = _inception_c(160)
        self.Mixed_6e = _inception_c(192)
        self.Mixed_7a = _block([
            ("branch3x3_1", 768, 192, 1), ("branch3x3_2", 192, 320, 3, 2),
            ("branch7x7x3_1", 768, 192, 1),
            ("branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3)),
            ("branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0)),
            ("branch7x7x3_4", 192, 192, 3, 2)])
        self.Mixed_7b = _inception_e(1280)
        self.Mixed_7c = _inception_e(2048)

    @staticmethod
    def _run_a(p, x):
        b1 = p["branch1x1"](x)
        b5 = p["branch5x5_2"](p["branch5x5_1"](x))
        b3 = p["branch3x3dbl_3"](p["branch3x3dbl_2"](p["branch3x3dbl_1"](x)))
        return torch.cat([b1, b5, b3, p["branch_pool"](_avgpool3(x))], 1)

    @staticmethod
    def _run_b(p, x):
        b3 = p["branch3x3"](x)
        bd = p["branch3x3dbl_3"](p["branch3x3dbl_2"](p["branch3x3dbl_1"](x)))
        return torch.cat([b3, bd, _maxpool(x)], 1)

    @staticmethod
    def _run_c(p, x):
        b1 = p["branch1x1"](x)
        b7 = p["branch7x7_3"](p["branch7x7_2"](p["branch7x7_1"](x)))
        bd = x
        for i in range(1, 6):
            bd = p[f"branch7x7dbl_{i}"](bd)
        return torch.cat([b1, b7, bd, p["branch_pool"](_avgpool3(x))], 1)

    @staticmethod
    def _run_d(p, x):
        b3 = p["branch3x3_2"](p["branch3x3_1"](x))
        b7 = x
        for i in range(1, 5):
            b7 = p[f"branch7x7x3_{i}"](b7)
        return torch.cat([b3, b7, _maxpool(x)], 1)

    @staticmethod
    def _run_e(p, x, pool):
        b1 = p["branch1x1"](x)
        b3 = p["branch3x3_1"](x)
        b3 = torch.cat([p["branch3x3_2a"](b3), p["branch3x3_2b"](b3)], 1)
        bd = p["branch3x3dbl_2"](p["branch3x3dbl_1"](x))
        bd = torch.cat([p["branch3x3dbl_3a"](bd), p["branch3x3dbl_3b"](bd)],
                       1)
        bp = p["branch_pool"](pool(x))
        return torch.cat([b1, b3, bd, bp], 1)

    def forward(self, images_unit, fid_variant: bool = True):
        """images_unit: (B, H, W, 3) in [0, 1] (299x299 for FID). Returns
        (B, 2048) features. fid_variant: the TF-port pools (module
        docstring)."""
        x = images_unit.permute(0, 3, 1, 2) * 2.0 - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _maxpool(x)
        x = _maxpool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        for blk in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d):
            x = self._run_a(blk, x)
        x = self._run_b(self.Mixed_6a, x)
        for blk in (self.Mixed_6b, self.Mixed_6c, self.Mixed_6d,
                    self.Mixed_6e):
            x = self._run_c(blk, x)
        x = self._run_d(self.Mixed_7a, x)
        x = self._run_e(self.Mixed_7b, x, _avgpool3)
        x = self._run_e(self.Mixed_7c, x,
                        _maxpool3_same if fid_variant else _avgpool3)
        return x.mean(dim=(2, 3))


@torch.no_grad()
def random_inception(generator: torch.Generator) -> InceptionV3:
    """The network on generator.device, drawn in parameter order with the
    JAX package's init: kernels N(0, 1) / sqrt(fan_in), scale 1, bias 0."""
    with torch.device("meta"):
        model = InceptionV3()
    model = model.to_empty(device=generator.device)
    for name, p in model.named_parameters():
        if name.endswith(".weight"):
            p.normal_(0.0, 1.0 / math.sqrt(math.prod(p.shape[1:])),
                      generator=generator)
        else:
            p.fill_(1.0 if name.endswith(".scale") else 0.0)
    return model.requires_grad_(False).eval()


def convert_inception_state_dict(sd) -> Dict[str, torch.Tensor]:
    """A torchvision inception_v3 state dict ("<block>.conv.weight",
    "<block>.bn.{weight, bias, running_mean, running_var}") -> this
    network's state dict, each batch norm (eps 1e-3) folded into its conv's
    `scale` and `bias` in fp32 numpy, as inception.py:298-320 folds it; the
    auxiliary and classifier heads are not read."""
    with torch.device("meta"):
        names = [k for k, _ in InceptionV3().named_parameters()]
    out: Dict[str, torch.Tensor] = {}
    for k in names:
        prefix, field = k.rsplit(".", 1)
        if field != "weight":
            continue

        def get(key):
            return np.asarray(torch.as_tensor(sd[f"{prefix}.{key}"])
                              .detach().float().cpu())
        var = get("bn.running_var")
        scale = get("bn.weight") / np.sqrt(var + np.float32(1e-3))
        out[k] = torch.from_numpy(get("conv.weight"))
        out[prefix + ".scale"] = torch.from_numpy(scale)
        out[prefix + ".bias"] = torch.from_numpy(
            get("bn.bias") - get("bn.running_mean") * scale)
    return out
