"""Serving engine: the uint8-in / uint8-out edge_to_image path (counterpart
of `img2img_turbo_tpu/serving/engine.py:26-38, 73-168`).

uint8 RGB -> on-device canny -> VAE encode (posterior sample) -> UNet at
t=999 on a cached prompt embedding -> closed-form x0 -> skip-fused VAE
decode -> uint8, all on one device, with parameters and the prompt
embedding in bf16. `use_kernels=False` runs the plain PyTorch path on the
same weights (the reference the kernel path is checked against); there is
no other way to reach it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from img2img_turbo_tpu_torch import resolve_device, scheduler
from img2img_turbo_tpu_torch.models.layers import prepare_kernels
from img2img_turbo_tpu_torch.ops import canny as canny_mod
from img2img_turbo_tpu_torch.ops import image as image_mod
from img2img_turbo_tpu_torch.pipelines.pix2pix import (GeneratorConfigs,
                                                       generate_unclamped)


def _serve_edge(unet, vae, cfgs: GeneratorConfigs, alphas, image_u8,
                caption_enc, low: float, high: float, *, kernels: bool,
                noise=None, generator=None) -> Dict[str, torch.Tensor]:
    """uint8 RGB -> canny control -> one-step generator -> uint8 RGB.
    Returns the uint8 output under "out", with the scaled latent "z", the
    denoised latent "x0" and the decoded image before the uint8 cast
    "img"."""
    c_t = canny_mod.canny_3ch_unit(image_u8, low, high).to(caption_enc.dtype)
    res = generate_unclamped(unet, vae, cfgs, alphas, c_t, caption_enc,
                             kernels=kernels, noise=noise,
                             generator=generator)
    res["out"] = image_mod.signed_to_uint8(res["img"])
    return res


class ServingEngine:
    """One-step edge_to_image server on one device.

    params: {"unet": UNet2DConditionModel, "vae": AutoencoderKL} with the
    LoRA-merged weights loaded. They are moved to `device` (the CUDA card
    unless the caller names another; without a card the caller must pass
    device="cpu"), cast to `dtype` and given their kernel-ready layouts
    once, here."""

    def __init__(self, params: Dict[str, torch.nn.Module],
                 cfgs: Optional[GeneratorConfigs] = None,
                 mode: str = "edge_to_image", dtype=torch.bfloat16,
                 canny_low: float = 100.0, canny_high: float = 200.0,
                 device=None, use_kernels: bool = True):
        if mode != "edge_to_image":
            raise NotImplementedError(
                f"serving mode {mode!r} is not ported yet (edge_to_image is)")
        self.cfgs = cfgs or GeneratorConfigs()
        self.mode, self.dtype = mode, dtype
        self.canny_low, self.canny_high = canny_low, canny_high
        self.use_kernels = use_kernels
        self.device = resolve_device(device)
        self.unet = prepare_kernels(
            params["unet"].to(device=self.device, dtype=dtype).eval())
        self.vae = prepare_kernels(
            params["vae"].to(device=self.device, dtype=dtype).eval())
        self.alphas = scheduler.make_alphas_cumprod(device=self.device)

    @torch.no_grad()
    def run(self, image_u8, caption_enc, generator=None,
            noise=None) -> Dict[str, torch.Tensor]:
        """image_u8: (B, H, W, 3) uint8 (numpy or tensor), H and W
        multiples of 8; caption_enc: (1 or B, 77, cross_dim). The posterior
        noise is `noise` when given, else drawn from `generator` (a
        torch.Generator on the engine's device; seed 0 when None)."""
        if not isinstance(image_u8, torch.Tensor):
            image_u8 = torch.from_numpy(np.asarray(image_u8))
        image_u8 = image_u8.to(self.device)
        if image_u8.dtype != torch.uint8 or image_u8.ndim != 4 \
                or image_u8.shape[-1] != 3:
            raise ValueError("image_u8 must be (B, H, W, 3) uint8, got "
                             f"{tuple(image_u8.shape)} {image_u8.dtype}")
        b, h, w, _ = image_u8.shape
        if h % 8 or w % 8:
            raise ValueError(f"H and W must be multiples of 8, got {(h, w)}")
        caption_enc = caption_enc.to(device=self.device, dtype=self.dtype)
        if caption_enc.shape[0] != b:
            caption_enc = caption_enc.expand(b, *caption_enc.shape[1:])
        caption_enc = caption_enc.contiguous()
        if noise is None and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return _serve_edge(self.unet, self.vae, self.cfgs, self.alphas,
                           image_u8, caption_enc, self.canny_low,
                           self.canny_high, kernels=self.use_kernels,
                           noise=noise, generator=generator)

    def __call__(self, image_u8, caption_enc, generator=None, noise=None):
        """Returns the uint8 (B, H, W, 3) output on the engine's device."""
        return self.run(image_u8, caption_enc, generator, noise)["out"]

    def warmup(self, batch: int, height: int, width: int, caption_enc):
        dummy = torch.zeros((batch, height, width, 3), dtype=torch.uint8,
                            device=self.device)
        self(dummy, caption_enc)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self
