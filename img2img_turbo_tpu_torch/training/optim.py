"""AdamW with global-norm clipping and the LR schedules, in torch.optim
terms, matching optax's update (counterpart of
`img2img_turbo_tpu/training/optim.py`: `optax.chain(clip_by_global_norm,
adamw)` and the diffusers `get_scheduler` names built from optax
schedules).

Per step, over all parameters of the optimizer:
  g <- g * max_norm / ||g||   when ||g|| >= max_norm (global L2 norm)
  m <- b1 m + (1 - b1) g,  v <- b2 v + (1 - b2) g^2,  t <- t + 1
  u <- (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd * p
  p <- p - lr(t - 1) * u
all in fp32, as optax computes it.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def linear_schedule(init: float, end: float, steps: int) -> Callable:
    """optax.linear_schedule (a constant `init` when steps <= 0)."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps)
                                         / steps) + end


def polynomial_schedule(init, end, power, steps) -> Callable:
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps)
                                         / steps) ** power + end


def cosine_decay_schedule(init: float, steps: int, alpha: float = 0.0):
    def f(count):
        c = min(count, steps)
        cos = 0.5 * (1 + math.cos(math.pi * c / steps))
        return init * ((1 - alpha) * cos + alpha)
    return f


def join_schedules(schedules, boundaries) -> Callable:
    """optax.join_schedules: schedule i runs from boundary i-1, counted
    from there."""
    def f(count):
        i = sum(count >= b for b in boundaries)
        return schedules[i](count - (boundaries[i - 1] if i else 0))
    return f


def make_lr_schedule(name: str, lr: float, warmup_steps: int,
                     total_steps: int, num_cycles: int = 1,
                     power: float = 1.0) -> Callable:
    """count -> learning rate, for the reference's scheduler names."""
    warm = linear_schedule(0.0, lr, warmup_steps)
    if name == "constant":
        return lambda count: lr
    if name == "constant_with_warmup":
        return warm
    if name == "linear":
        return join_schedules(
            [warm, linear_schedule(lr, 0.0, max(1, total_steps
                                                - warmup_steps))],
            [warmup_steps])
    if name == "cosine":
        decay = max(total_steps, warmup_steps + 1)
        return join_schedules(
            [warm, cosine_decay_schedule(lr, decay - warmup_steps)],
            [warmup_steps])
    if name == "cosine_with_restarts":
        per = max(1, (total_steps - warmup_steps) // max(1, num_cycles))
        return join_schedules(
            [warm] + [cosine_decay_schedule(lr, per)] * num_cycles,
            [warmup_steps + i * per for i in range(num_cycles)])
    if name == "polynomial":
        return join_schedules(
            [warm, polynomial_schedule(lr, 0.0, power,
                                       max(1, total_steps - warmup_steps))],
            [warmup_steps])
    raise ValueError(f"unknown lr scheduler {name!r}")


class AdamW(torch.optim.Optimizer):
    """optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule, ...))
    as a torch optimizer; `schedule` maps the step count (from 0) to the
    learning rate. Reads each parameter's .grad; the clipping norm spans
    every parameter of the optimizer."""

    def __init__(self, params, schedule: Callable, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-2, max_grad_norm: float = 1.0):
        super().__init__(params, dict(beta1=beta1, beta2=beta2, eps=eps,
                                      weight_decay=weight_decay))
        self.schedule, self.max_grad_norm = schedule, max_grad_norm
        self.count = 0

    def __getstate__(self):
        # torch.optim keeps only defaults, state and groups; a copy of the
        # optimizer needs its schedule, clip norm and step count too
        st = super().__getstate__()
        st.update(schedule=self.schedule, max_grad_norm=self.max_grad_norm,
                  count=self.count)
        return st

    def state_dict(self):
        """torch.optim's state dict (the moments and groups) with the step
        count, which the schedule and the bias correction read."""
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = state_dict.pop("count")
        super().load_state_dict(state_dict)

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every parameter with a .grad, as a handful of
        multi-tensor (`torch._foreach_*`) launches per group: a loop over
        hundreds of LoRA factors would cost a dozen launches each."""
        params = [p for g in self.param_groups for p in g["params"]
                  if p.grad is not None]
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
            [p.grad.float() for p in params])))
        clip = torch.where(gnorm < self.max_grad_norm, torch.ones_like(gnorm),
                           self.max_grad_norm / gnorm)
        lr = self.schedule(self.count)
        self.count += 1
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            b1, b2 = group["beta1"], group["beta2"]
            for p in ps:
                if not self.state[p]:
                    self.state[p]["mu"] = torch.zeros_like(
                        p, dtype=torch.float32)
                    self.state[p]["nu"] = torch.zeros_like(
                        p, dtype=torch.float32)
            grads = torch._foreach_mul([p.grad.float() for p in ps], clip)
            mus = [self.state[p]["mu"] for p in ps]
            nus = [self.state[p]["nu"] for p in ps]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
            denom = torch._foreach_sqrt(torch._foreach_div(
                nus, 1 - b2 ** self.count))
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(torch._foreach_div(
                mus, 1 - b1 ** self.count), denom)
            torch._foreach_add_(upd, [p.float() for p in ps],
                                alpha=group["weight_decay"])
            torch._foreach_mul_(upd, lr)
            torch._foreach_sub_(ps, [u.to(p.dtype) for u, p in zip(upd, ps)])
        return None
