"""Training losses (counterpart of `img2img_turbo_tpu/training/losses.py`):
L2, L1, LPIPS, CLIP-similarity and the GAN losses of the paired loop
(train_pix2pix_turbo.py:175-224: l2*lambda_l2 + lpips*lambda_lpips +
clipsim*lambda_clipsim, then the GAN passes scaled by lambda_gan) and of the
unpaired loop (train_cyclegan_turbo.py:181-256: cycle and identity L1 +
LPIPS, then the GAN passes)."""

from __future__ import annotations

import dataclasses

from img2img_turbo_tpu_torch.models import clip_vit
from img2img_turbo_tpu_torch.models import discriminator as disc_mod
from img2img_turbo_tpu_torch.ops.image import resize_torch


@dataclasses.dataclass(frozen=True)
class PairedLossConfig:
    lambda_gan: float = 0.5
    lambda_lpips: float = 5.0
    lambda_l2: float = 1.0
    lambda_clipsim: float = 5.0
    gan_loss_type: str = "multilevel_sigmoid_s"


@dataclasses.dataclass(frozen=True)
class UnpairedLossConfig:
    lambda_gan: float = 0.5
    lambda_idt: float = 1.0
    lambda_cycle: float = 1.0
    lambda_cycle_lpips: float = 10.0
    lambda_idt_lpips: float = 1.0
    gan_loss_type: str = "multilevel_sigmoid"


def l2_loss(pred, target):
    return (pred.float() - target.float()).square().mean()


def l1_loss(pred, target):
    return (pred.float() - target.float()).abs().mean()


def lpips_loss(lpips_model, pred, target):
    return lpips_model(pred, target).mean()


def clipsim_loss(clip_model, pred, input_ids):
    """1 - clipsim/100 on images resized bilinearly (no antialias) to the
    tower's size (train_pix2pix_turbo.py:181-187)."""
    size = clip_model.cfg.image_size
    x = resize_torch(pred, size, size, "bilinear")
    return (1.0 - clip_vit.clip_similarity(clip_model, x, input_ids)
            / 100.0).mean()


def gan_gen_loss(backbone, heads, sn, fake, smooth: bool):
    return disc_mod.disc_loss(backbone, heads, sn, fake, for_G=True,
                              smooth=smooth)


def gan_disc_real_loss(backbone, heads, sn, real, smooth: bool):
    return disc_mod.disc_loss(backbone, heads, sn, real, for_real=True,
                              smooth=smooth)


def gan_disc_fake_loss(backbone, heads, sn, fake, smooth: bool):
    return disc_mod.disc_loss(backbone, heads, sn, fake.detach(),
                              for_real=False, smooth=smooth)
