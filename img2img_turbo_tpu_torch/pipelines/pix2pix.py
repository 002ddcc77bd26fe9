"""Pix2Pix-Turbo generators (counterpart of
`img2img_turbo_tpu/pipelines/pix2pix.py:31-82`): VAE encode (posterior
sample) -> UNet at t=999 -> closed-form x0 -> skip-fused VAE decode, on
LoRA-merged weights (deterministic) or with LoRA merged at a runtime scale
r, the TwinConv blend and decoder gamma = r (stochastic, the sketch path).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from img2img_turbo_tpu_torch import configs
from img2img_turbo_tpu_torch import lora as lora_mod
from img2img_turbo_tpu_torch import scheduler
from img2img_turbo_tpu_torch.models.layers import has_kernel_layouts


class GeneratorConfigs:
    def __init__(self, unet=configs.SD_TURBO_UNET, vae=configs.SD_TURBO_VAE,
                 text=configs.SD_TURBO_TEXT):
        self.unet, self.vae, self.text = unet, vae, text


def generate_unclamped(unet, vae, cfgs: GeneratorConfigs, alphas_cumprod, c_t,
                       caption_enc, *, kernels: bool, noise=None,
                       generator: Optional[torch.Generator] = None,
                       remat: bool = False, r=None, noise_map=None):
    """The generator core on (B, H, W, 3) input. Returns {"z": the scaled
    latent, "x0": the denoised latent, "img": the decoded image before the
    clamp} (the serving engine rounds "img" to uint8). remat recomputes
    each UNet block in the backward (training). With r (a float or 0-d
    tensor) the stochastic path's blends: unet_in = z*r + noise_map*(1-r),
    the UNet's TwinConv at r and decoder gamma = r (pix2pix.py:72-81); the
    caller has merged LoRA at r."""
    s = cfgs.vae.scaling_factor
    z, skips = vae.encode(c_t, kernels=kernels, noise=noise,
                          generator=generator)
    z = z * s
    unet_in, gamma = z, 1.0
    if r is not None:
        r_ = torch.as_tensor(r, dtype=z.dtype, device=z.device)
        unet_in = z * r_ + noise_map.to(z.dtype) * (1.0 - r_)
        gamma = r
    t = torch.full((c_t.shape[0],), scheduler.ONE_STEP_T, dtype=torch.long,
                   device=c_t.device)
    eps = unet(unet_in, t, caption_enc, kernels=kernels, remat=remat, r=r)
    x0 = scheduler.ddpm_x0_step(eps, unet_in, t, alphas_cumprod)
    img = vae.decode(x0 / s, skips, gamma=gamma, kernels=kernels)
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


@contextlib.contextmanager
def lora_merged_at(unet, vae, lora: Dict, r):
    """Within the block, `unet` and `vae` hold their base weights with the
    factored adapters lora["unet"] / lora["vae"] merged at scale r (a
    float or 0-d tensor), through `lora.swap_params`: the modules run their
    live-weight path, so they must not hold kernel layouts
    (`prepare_kernels`), which would be stale."""
    for m in (unet, vae):
        if any(has_kernel_layouts(sub) for sub in m.modules()):
            raise ValueError("the stochastic path merges LoRA per call: run "
                             "it on modules without kernel layouts")
    merged = {name: lora_mod.merge_lora(dict(m.named_parameters()),
                                        lora[name], scale=r)
              for name, m in (("unet", unet), ("vae", vae))}
    with lora_mod.swap_params(unet, merged["unet"]), \
            lora_mod.swap_params(vae, merged["vae"]):
        yield


def generate_stochastic(unet, vae, lora: Dict, cfgs: GeneratorConfigs,
                        alphas_cumprod, c_t, caption_enc, r, noise_map, *,
                        kernels: bool = True, noise=None,
                        generator: Optional[torch.Generator] = None):
    """The stochastic sketch path (pix2pix.py:60-82). unet: with a TwinConv
    conv_in (`models.unet.make_twin_conv_in`); unet / vae hold the base
    weights and no kernel layouts; lora: {"unet", "vae"} factored adapters,
    merged at r; r: a float or 0-d tensor in [0, 1]; noise_map:
    (B, H/8, W/8, 4); the posterior noise is `noise`, or drawn from
    `generator`. Returns (B, H, W, 3) in [-1, 1]."""
    with lora_merged_at(unet, vae, lora, r):
        img = generate_unclamped(unet, vae, cfgs, alphas_cumprod, c_t,
                                 caption_enc, kernels=kernels, noise=noise,
                                 generator=generator, r=r,
                                 noise_map=noise_map)["img"]
    return torch.clamp(img, -1.0, 1.0)
