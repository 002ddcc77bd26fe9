"""The comparison that decides `correct`, and the control's precision.

Each served request of the sample is compared with the plain fp32
reference on the same inputs (images, caption embedding, posterior noise,
weights drawn from the same seed), by three numbers, each the worst over
the sampled requests:
- x0_rel_l2: ||x0 - x0_ref|| / ||x0_ref||, the denoised latent (VAE
  encoder, posterior sample, UNet at t=999, the x0 step);
- img_rel_l2: the same of the decoded image before the uint8 cast (the
  skip-fused decoder on top);
- out_mean_abs: the mean absolute difference of the uint8 outputs, in
  levels of 255.
A training cell compares the first steps of the paired trainer with the
reference's (`train_readings`). Each number has its limit in the cell's
`port_bench/workloads/<cell>.json`.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

NUMBERS = ("x0_rel_l2", "img_rel_l2", "out_mean_abs")
TRAIN_NUMBERS = ("loss_rel", "grad1_gap", "update_gap")
# a leaf whose first gradient in the reference is under this share of the
# median leaf's moves under AdamW by round-off alone: its change is not
# compared
MOVED = 1e-3


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for matmuls and convolutions within the block: the
    reference computes in fp32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = saved


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale a tensor (its largest
    magnitude at 448), back in fp32: the control's operands."""
    x = x.float()
    s = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def fp8_through(x: torch.Tensor) -> torch.Tensor:
    """fp8_round in the forward, the identity in the backward."""
    return x + (fp8_round(x) - x).detach()


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def readings(port: Dict[str, torch.Tensor],
             ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers of one request: port and ref hold "x0", "img" (NHWC,
    any float dtype) and "out" (NHWC uint8)."""
    return {"x0_rel_l2": _rel(port["x0"], ref["x0"]),
            "img_rel_l2": _rel(port["img"], ref["img"]),
            "out_mean_abs": (port["out"].float()
                             - ref["out"].float()).abs().mean().item()}


def worst(per_request: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in per_request) for k in per_request[0]}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, List[str]]:
    """(every number within its limit, one line a number). A number that
    is not finite fails."""
    ok, lines = True, []
    for k, lim in limits.items():
        v = numbers[k]
        good = v == v and abs(v) != float("inf") and v <= lim
        ok &= good
        lines.append(f"{k} {v!r} limit {lim!r} {'ok' if good else 'FAIL'}")
    return ok, lines


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def delta_norms(after, before) -> Dict[str, float]:
    """{leaf: ||after - before||}."""
    return {k: (after[k].detach().float() - before[k].float()).norm().item()
            for k in before}


def first_moments(opt, params: Dict[str, torch.Tensor]):
    """{leaf: AdamW's first moment} of `params` in the port's optimizer
    (a zero where it holds none: a step that never updated)."""
    return {k: opt.state[p]["mu"] if "mu" in opt.state[p]
            else torch.zeros(1, device=p.device) for k, p in params.items()}


def norms(d) -> Dict[str, float]:
    return {k: v.detach().float().norm().item() for k, v in d.items()}


def train_summary(out) -> Dict:
    """What the comparison reads of a reference run
    (`reference.paired_step.run`): each step's losses, the norm of each
    trainable's first moment after the first step, of its change over the
    steps, and the two groups (generator, heads) of leaves."""
    return {"losses": out["losses"], "mu1": norms(out["mu1"]),
            "delta": {**delta_norms(out["gen"], out["gen0"]),
                      **delta_norms(out["heads"], out["heads0"])},
            "groups": [sorted(out["gen0"]), sorted(out["heads0"])]}


def _median(values):
    v = sorted(values)
    return v[len(v) // 2]


def _worst_gap(got, ref, keep) -> float:
    """The largest |got - ref| / max(ref, median ref) over the kept
    leaves."""
    med = _median([ref[k] for k in keep])
    return max(abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep)


def train_readings(got, ref) -> Dict[str, float]:
    """loss_rel: the largest relative gap of any pass's loss over the
    compared steps; grad1_gap: of the norm of AdamW's first moment after
    the first step, (1 - b1)(b1 g_a + g_b) of its two passes' clipped
    gradients (generator: passes 1 and 2; heads: passes 3 and 4), by the
    worst leaf of either group; update_gap: of the norm of each trainable's
    change over the compared steps, the same way. In each group, leaves
    whose reference first moment is under MOVED of the group's median are
    left out: a rule on the reference's gradient."""
    loss = max(abs(g[k] - r[k]) / max(abs(r[k]), 1e-30)
               for g, r in zip(got["losses"], ref["losses"]) for k in r)
    grad, delta, left = 0.0, 0.0, 0
    for group in ref["groups"]:
        med = _median([ref["mu1"][k] for k in group])
        keep = [k for k in group if ref["mu1"][k] >= MOVED * med]
        left += len(group) - len(keep)
        grad = max(grad, _worst_gap(got["mu1"], ref["mu1"], keep))
        delta = max(delta, _worst_gap(got["delta"], ref["delta"], keep))
    return {"loss_rel": loss, "grad1_gap": grad, "update_gap": delta,
            "leaves_left_out": left}
