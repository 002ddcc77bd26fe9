"""One-step DDPM scheduler (counterpart of `img2img_turbo_tpu.scheduler`).

SD-Turbo runs its UNet once at t=999; the final DDPM step then reduces to
the closed-form x0 prediction
    x0 = (x_t - sqrt(1 - abar_t) * eps) / sqrt(abar_t).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"


SD_TURBO_SCHED = SchedulerConfig()
ONE_STEP_T = 999


def make_alphas_cumprod(cfg: SchedulerConfig = SD_TURBO_SCHED,
                        device=None) -> torch.Tensor:
    """(num_train_timesteps,) float32 cumulative alpha products."""
    if cfg.beta_schedule == "scaled_linear":
        betas = torch.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                               cfg.num_train_timesteps,
                               dtype=torch.float32, device=device) ** 2
    elif cfg.beta_schedule == "linear":
        betas = torch.linspace(cfg.beta_start, cfg.beta_end,
                               cfg.num_train_timesteps, dtype=torch.float32,
                               device=device)
    else:
        raise ValueError(f"unknown beta schedule {cfg.beta_schedule}")
    return torch.cumprod(1.0 - betas, dim=0)


def ddpm_x0_step(eps, sample, timesteps, alphas_cumprod):
    """Closed-form final DDPM step (epsilon prediction, alpha_bar_prev = 1),
    computed in fp32 and cast back to eps.dtype. timesteps: (B,) ints."""
    abar = alphas_cumprod[timesteps].float()
    abar = abar.reshape(abar.shape + (1,) * (sample.ndim - 1))
    x0 = (sample.float() - torch.sqrt(1.0 - abar) * eps.float()) \
        / torch.sqrt(abar)
    return x0.to(eps.dtype)
