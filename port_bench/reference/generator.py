"""The served request in plain fp32: uint8 in -> canny edges (edge mode) or
[-1, 1] (image mode) -> VAE encode with its posterior sample -> UNet at
t=999 -> closed-form x0 -> skip-fused VAE decode -> uint8 out."""

from __future__ import annotations

import torch

from port_bench.reference import sd_turbo
from port_bench.reference.canny import canny


def alphas_cumprod(sched) -> torch.Tensor:
    """diffusers DDPMScheduler's cumulative alphas, scaled_linear betas."""
    n = sched["num_train_timesteps"]
    if sched["beta_schedule"] != "scaled_linear":
        raise ValueError(f"beta schedule {sched['beta_schedule']!r}")
    betas = torch.linspace(sched["beta_start"] ** 0.5,
                           sched["beta_end"] ** 0.5, n,
                           dtype=torch.float32) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


def control_input(cfg, mode: str, image_u8):
    """(B, 3, H, W) fp32 generator input of a uint8 (B, H, W, 3) batch."""
    if mode == "edge_to_image":
        e = canny(image_u8, cfg["canny"]["low"], cfg["canny"]["high"])
        return e[:, None].expand(-1, 3, -1, -1)
    if mode == "image":
        return image_u8.float().permute(0, 3, 1, 2) / 127.5 - 1.0
    raise ValueError(f"serving mode {mode!r}")


def serve(p_unet, p_vae, cfg, mode, image_u8, caption, noise,
          q=sd_turbo.ident):
    """One request. image_u8 (B, H, W, 3) uint8; caption (1 or B, 77,
    cross_dim); noise (B, H/8, W/8, latent) the posterior sample's normal
    draw. Returns {"x0", "img"} NHWC fp32 and "out" NHWC uint8."""
    ucfg, vcfg, sched = cfg["unet"], cfg["vae"], cfg["scheduler"]
    b = image_u8.shape[0]
    c_t = control_input(cfg, mode, image_u8)
    mean, logvar, skips = sd_turbo.vae_encode(p_vae, vcfg, c_t, q)
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    s = vcfg["scaling_factor"]
    z = (mean + std * noise.float().permute(0, 3, 1, 2)) * s
    t = torch.full((b,), sched["timestep"], dtype=torch.long,
                   device=z.device)
    ctx = caption.float().expand(b, -1, -1)
    eps = sd_turbo.unet(p_unet, ucfg, z, t, ctx, q)
    abar = alphas_cumprod(sched)[sched["timestep"]].item()
    x0 = (z - (1.0 - abar) ** 0.5 * eps) / abar ** 0.5
    img = sd_turbo.vae_decode(p_vae, vcfg, x0 / s, skips, 1.0, q)
    out = torch.round((img.clamp(-1.0, 1.0) * 0.5 + 0.5) * 255.0)
    nhwc = (lambda t_: t_.permute(0, 2, 3, 1))
    return {"x0": nhwc(x0), "img": nhwc(img),
            "out": nhwc(out.clamp(0, 255).to(torch.uint8))}
