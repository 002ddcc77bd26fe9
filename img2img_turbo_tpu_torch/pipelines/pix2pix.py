"""Pix2Pix-Turbo deterministic generator (counterpart of
`img2img_turbo_tpu/pipelines/pix2pix.py:31-57`): VAE encode (posterior
sample) -> UNet at t=999 -> closed-form x0 -> skip-fused VAE decode."""

from __future__ import annotations

from typing import Optional

import torch

from img2img_turbo_tpu_torch import configs
from img2img_turbo_tpu_torch import scheduler


class GeneratorConfigs:
    def __init__(self, unet=configs.SD_TURBO_UNET, vae=configs.SD_TURBO_VAE,
                 text=configs.SD_TURBO_TEXT):
        self.unet, self.vae, self.text = unet, vae, text


def generate_unclamped(unet, vae, cfgs: GeneratorConfigs, alphas_cumprod, c_t,
                       caption_enc, *, kernels: bool, noise=None,
                       generator: Optional[torch.Generator] = None,
                       remat: bool = False):
    """The generator core on (B, H, W, 3) input. Returns {"z": the scaled
    latent, "x0": the denoised latent, "img": the decoded image before the
    clamp} (the serving engine rounds "img" to uint8). remat recomputes
    each UNet block in the backward (training)."""
    s = cfgs.vae.scaling_factor
    z, skips = vae.encode(c_t, kernels=kernels, noise=noise,
                          generator=generator)
    z = z * s
    t = torch.full((c_t.shape[0],), scheduler.ONE_STEP_T, dtype=torch.long,
                   device=c_t.device)
    eps = unet(z, t, caption_enc, kernels=kernels, remat=remat)
    x0 = scheduler.ddpm_x0_step(eps, z, t, alphas_cumprod)
    img = vae.decode(x0 / s, skips, gamma=1.0, kernels=kernels)
    return {"z": z, "x0": x0, "img": img}


def generate_deterministic(unet, vae, cfgs: GeneratorConfigs, alphas_cumprod,
                           c_t, caption_enc, *, kernels: bool = True,
                           noise=None,
                           generator: Optional[torch.Generator] = None,
                           remat: bool = False):
    """unet / vae: the LoRA-merged modules. c_t: (B, H, W, 3) in [0, 1]
    (edge map) or [-1, 1]; caption_enc: (B, 77, cross_dim). Returns
    (B, H, W, 3) in [-1, 1]. remat: as in `generate_unclamped`
    (pix2pix.py:31-57)."""
    img = generate_unclamped(unet, vae, cfgs, alphas_cumprod, c_t,
                             caption_enc, kernels=kernels, noise=noise,
                             generator=generator, remat=remat)["img"]
    return torch.clamp(img, -1.0, 1.0)
