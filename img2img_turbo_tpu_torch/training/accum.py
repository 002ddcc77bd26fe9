"""Gradient accumulation over micro-batches (counterpart of
`img2img_turbo_tpu/training/accum.py`).

The reference accumulates with `accelerator.accumulate`: k micro-batch
backwards, one optimizer step (train_pix2pix_turbo.py:170,
train_cyclegan_turbo.py:168). Here a Python loop runs autograd on one
micro-batch at a time and adds its gradients into fp32 accumulators, so
activation memory is one micro-batch's, as with the JAX package's
`lax.scan`; the mean over the k micro-batches feeds one optimizer update.
Every loss of the trainers is a batch mean over equal micro-batches, so the
mean gradient is the whole batch's (up to the order of the fp32 sums).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from img2img_turbo_tpu_torch.utils import profiling


def split_micro(data: Dict[str, torch.Tensor], k: int
                ) -> List[Dict[str, torch.Tensor]]:
    """{name: (B, ...)} -> k dictionaries of (B // k, ...) slices, in batch
    order. B must be divisible by k."""
    out = [dict() for _ in range(k)]
    for name, x in data.items():
        if x.shape[0] % k:
            raise ValueError(f"batch dim {x.shape[0]} of {name!r} is not "
                             f"divisible by accum_steps {k}")
        for d, part in zip(out, x.split(x.shape[0] // k)):
            d[name] = part
    return out


def merge_micro(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Inverse of split_micro for one per-micro-batch output: the parts
    concatenated along the batch dim."""
    return parts[0] if len(parts) == 1 else torch.cat(list(parts))


def mean_aux(auxes: Sequence[Dict[str, torch.Tensor]]
             ) -> Dict[str, torch.Tensor]:
    """Per-micro-batch scalar metrics -> their mean over the micro-batches
    (the one dictionary itself for a single micro-batch)."""
    if len(auxes) == 1:
        return auxes[0]
    return {k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}


def accumulated_grads(loss_fn: Callable, params: Dict[str, torch.Tensor],
                      data: Dict[str, torch.Tensor], k: int
                      ) -> Tuple[torch.Tensor, List, Dict[str, torch.Tensor]]:
    """loss_fn(micro_data) -> (loss, aux): the loss (detached, the mean over
    the micro-batches), the k auxes in batch order and the gradients of the
    loss with respect to `params`, the mean over the micro-batches. k == 1
    is one autograd call on the whole batch. For k > 1 the graph each
    micro-batch shares with the others (a weight merge done once, before
    the loop) is kept until the last backward."""
    if k == 1:
        with profiling.span("i2i.train.forward"):
            loss, aux = loss_fn(data)
        with profiling.span("i2i.train.backward"):
            grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), [aux], dict(zip(params, grads))
    acc = {n: torch.zeros_like(p, dtype=torch.float32)
           for n, p in params.items()}
    losses, auxes = [], []
    for i, micro in enumerate(split_micro(data, k)):
        with profiling.span("i2i.train.forward"):
            loss, aux = loss_fn(micro)
        with profiling.span("i2i.train.backward"):
            grads = torch.autograd.grad(loss, list(params.values()),
                                        retain_graph=i < k - 1)
            for g, s in zip(grads, acc.values()):
                s.add_(g.float())
        losses.append(loss.detach())
        auxes.append(aux)
        del loss, grads
    grads = {n: (s / k).to(params[n].dtype) for n, s in acc.items()}
    return torch.stack(losses).mean(), auxes, grads
