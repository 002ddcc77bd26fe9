"""The unpaired trainer's validation: FID in each direction and the mean
DINO-Struct (counterpart of `img2img_turbo_tpu/training/eval_unpaired.py`;
reference train_cyclegan_turbo.py:89-125 and :311-379).

The reference statistics of each direction come from the val-transformed
test images of its target domain, saved once as PNGs under
`<out_dir>/fid_reference_<tag>/`. A validation translates every test image
of the source domain (or the first `max_images`), saves each translation
under `<out_dir>/fid-<step>/samples_<tag>/`, and reports `fid_<tag>`
against the reference statistics and `dino_struct_<tag>`, the mean
DINO-Struct distance between each input and its translation.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from img2img_turbo_tpu_torch.metrics import fid as fid_mod


def cache_reference_fid_stats(inception, image_paths: List[str], transform,
                              out_dir: str, tag: str
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Save the val-transformed reference images (once) and return their
    (mu, sigma) under `inception` (an `InceptionV3`)."""
    from PIL import Image
    ref_dir = os.path.join(out_dir, f"fid_reference_{tag}")
    os.makedirs(ref_dir, exist_ok=True)
    imgs = []
    for path in sorted(image_paths):
        outf = os.path.join(
            ref_dir, os.path.basename(path).replace(".jpg", ".png"))
        if not os.path.exists(outf):
            transform(Image.open(path).convert("RGB")).save(outf)
        imgs.append(np.asarray(Image.open(outf).convert("RGB"), np.uint8))
    return fid_mod.compute_stats(fid_mod.features_from_images(inception,
                                                              imgs))


def translations(fwd_fn: Callable, image_paths: List[str], transform,
                 device, max_images: int = -1):
    """(path, the val-transformed source image, its translation as uint8)
    for the sorted test images (the first `max_images` when positive), in
    that order; fwd_fn as in `evaluate_direction`. Under a model axis the
    ranks that score nothing run it too, so that every rank of the model
    group makes the same calls of the sharded UNet and VAE."""
    from PIL import Image
    paths = sorted(image_paths)
    if max_images > 0:
        paths = paths[:max_images]
    for path in paths:
        src = transform(Image.open(path).convert("RGB"))
        arr = np.asarray(src, np.float32) / 127.5 - 1.0
        with torch.no_grad():
            out = fwd_fn(torch.from_numpy(arr)[None].to(device))
        out = out[0].float().cpu().numpy()
        yield path, src, np.clip((out * 0.5 + 0.5) * 255.0, 0,
                                 255).astype(np.uint8)


def evaluate_direction(fwd_fn: Callable, image_paths: List[str], transform,
                       inception, ref_stats, dino, out_dir: str, tag: str,
                       step: int, max_images: int = -1
                       ) -> Dict[str, float]:
    """Translate the test images; FID against `ref_stats` and the mean
    DINO-Struct. fwd_fn: (1, H, W, 3) float32 in [-1, 1] on the inception
    model's device -> the translation, (1, H, W, 3) in [-1, 1]. dino: a
    `DinoStructureLoss`, or None to skip it."""
    from PIL import Image
    device = next(inception.parameters()).device
    viz_dir = os.path.join(out_dir, f"fid-{step}", f"samples_{tag}")
    os.makedirs(viz_dir, exist_ok=True)
    outputs, dino_scores = [], []
    for path, src, out_u8 in translations(fwd_fn, image_paths, transform,
                                          device, max_images):
        Image.fromarray(out_u8).save(os.path.join(
            viz_dir, os.path.basename(path).replace(".jpg", ".png")))
        outputs.append(out_u8)
        if dino is not None:
            a = dino.preprocess(src)
            b = dino.preprocess(Image.fromarray(out_u8))
            dino_scores.append(dino.calculate_global_ssim_loss(b, a))
    mu, sigma = fid_mod.compute_stats(
        fid_mod.features_from_images(inception, outputs))
    metrics = {f"fid_{tag}": fid_mod.frechet_distance(
        mu, sigma, ref_stats[0], ref_stats[1])}
    if dino_scores:
        metrics[f"dino_struct_{tag}"] = float(np.mean(dino_scores))
    return metrics
