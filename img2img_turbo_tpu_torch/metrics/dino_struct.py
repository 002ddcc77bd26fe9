"""The DINO-Structure metric (counterpart of
`img2img_turbo_tpu/metrics/dino_struct.py`; reference
src/my_utils/dino_struct.py:161-185): per image, the cosine
self-similarity of the DINO ViT keys at block 11 (the last block of a
shallower test model), and the mean squared difference of the input's and
the translation's maps.

The preprocess is torchvision's `Resize(224)` on a PIL image: the short
side to 224 with the aspect kept, bilinear, the long side truncated with
int() (dino_struct.py:69-84). A non-square image keeps a non-square patch
grid, and the model resizes its position embedding to it.
"""

from __future__ import annotations

import numpy as np
import torch

from img2img_turbo_tpu_torch.models import dino as dino_mod

LAYER = 11


def _attn_cosine_sim(x, eps: float = 1e-08):
    """x: (1, tokens, feats) -> (1, tokens, tokens) cosine similarities."""
    norm = torch.linalg.norm(x, dim=2, keepdim=True)
    factor = torch.clamp(norm @ norm.transpose(1, 2), min=eps)
    return (x @ x.transpose(1, 2)) / factor


def keys_self_sim(model: dino_mod.DINO, image_unit, layer_num: int = LAYER):
    """image_unit: (1, H, W, 3) in [0, 1]. Returns (1, T, T): the
    self-similarity of block min(layer_num, depth - 1)'s keys, heads
    concatenated, the class token included."""
    mean = torch.tensor(dino_mod.IMAGENET_MEAN, device=image_unit.device,
                        dtype=image_unit.dtype)
    std = torch.tensor(dino_mod.IMAGENET_STD, device=image_unit.device,
                       dtype=image_unit.dtype)
    _, qkvs = model((image_unit - mean) / std)
    k = qkvs[min(layer_num, len(qkvs) - 1)]["k"]
    b, h, t, hd = k.shape
    return _attn_cosine_sim(k.transpose(1, 2).reshape(b, t, h * hd))


def dino_struct_distance(model: dino_mod.DINO, src_unit, out_unit,
                         layer_num: int = LAYER):
    """Mean squared difference of the two self-similarity maps."""
    a = keys_self_sim(model, src_unit, layer_num)
    b = keys_self_sim(model, out_unit, layer_num)
    return torch.mean(torch.square(a - b))


class DinoStructureLoss:
    """The reference's API (dino_struct.py:169-185) on a port DINO model:
    `model`, or the JAX package's random init (seed 0) at `cfg` on
    `device` (the CUDA card unless the caller names another)."""

    def __init__(self, model=None, cfg: dino_mod.DINOConfig =
                 dino_mod.DINO_VITB8, device=None):
        from img2img_turbo_tpu_torch import resolve_device
        if model is None:
            g = torch.Generator(device=resolve_device(device)).manual_seed(0)
            model = dino_mod.random_dino(cfg, g)
        self.model, self.cfg = model, model.cfg
        self.device = next(model.parameters()).device

    def preprocess(self, pil_image, size: int = 224):
        """(1, H', W', 3) float32 in [0, 1] on the model's device: the short
        side to `size`, bilinear, the long side int(size * long / short)."""
        from PIL import Image
        img = pil_image.convert("RGB")
        w, h = img.size
        if w <= h:
            new_w, new_h = size, int(size * h / w)
        else:
            new_w, new_h = int(size * w / h), size
        img = img.resize((new_w, new_h), Image.BILINEAR)
        arr = np.asarray(img, np.float32) / 255.0
        return torch.from_numpy(arr)[None].to(self.device)

    @torch.no_grad()
    def calculate_global_ssim_loss(self, outputs, inputs) -> float:
        return float(dino_struct_distance(self.model, inputs, outputs))
