"""FID (counterpart of `img2img_turbo_tpu/metrics/fid.py`, the clean-fid
protocol): each uint8 image resized on the host to 299x299 with PIL bicubic
per channel in mode 'F' (no uint8 re-quantisation), InceptionV3 features
on the model's device in batches of 8 (the tail padded with its last
image, as in the JAX package), and the statistics and the Fréchet distance
in float64 numpy with scipy's sqrtm.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

BATCH = 8


def clean_resize_299(img_u8: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (299, 299, 3) float32 in [0, 1]: PIL bicubic per
    channel in float mode (fid.py:22-33)."""
    from PIL import Image
    out = np.empty((299, 299, 3), np.float32)
    for c in range(3):
        ch = Image.fromarray(img_u8[..., c].astype(np.float32), mode="F")
        out[..., c] = np.asarray(ch.resize((299, 299), Image.BICUBIC),
                                 np.float32)
    return out / 255.0


@torch.no_grad()
def features_from_images(model, images_u8: Iterable[np.ndarray],
                         batch_size: int = BATCH) -> np.ndarray:
    """images_u8: (H, W, 3) uint8 arrays. Returns (N, 2048) float64 from
    `model` (an `inception.InceptionV3`) on its own device."""
    dev = next(model.parameters()).device

    def run(batch):
        x = torch.from_numpy(np.stack(batch)).to(dev)
        return model(x).double().cpu().numpy()

    feats, batch = [], []
    for img in images_u8:
        batch.append(clean_resize_299(img))
        if len(batch) == batch_size:
            feats.append(run(batch))
            batch = []
    if batch:
        n = len(batch)
        batch += [batch[-1]] * (batch_size - n)
        feats.append(run(batch)[:n])
    return np.concatenate(feats).astype(np.float64)


def compute_stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return np.mean(feats, axis=0), np.cov(feats, rowvar=False)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """The Fréchet distance of two Gaussians, in float64 with scipy's
    sqrtm; a non-finite square root is retried with eps on the diagonals
    (fid.py:59-70). sqrtm is called without `disp` (the JAX module's
    disp=False): scipy 1.18 removed the argument, and the root is the same
    either way."""
    from scipy import linalg
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def fid_from_feats(feats1: np.ndarray, feats2: np.ndarray) -> float:
    mu1, s1 = compute_stats(feats1)
    mu2, s2 = compute_stats(feats2)
    return frechet_distance(mu1, s1, mu2, s2)
