"""Full-state checkpoints of a training run (counterpart of
`img2img_turbo_tpu/training/checkpoint.py`, with `torch.save` in place of
orbax).

The reference pickles adapter weights only and cannot resume (SURVEY.md
§5). A checkpoint here is the whole `TrainState` of a paired or an
unpaired run: the generator trainables, the discriminator heads and
spectral-norm vectors, both AdamW states (moments and step count) and the
step, one file per step, `<step>.pt` in the directory; the newest
`max_to_keep` are kept, as orbax's manager keeps them. A file is written
under a temporary name and renamed into place, so a run cut off while
saving leaves no partial checkpoint behind. The frozen models are not
saved: a run rebuilds them (from the same seed or weights) before it
restores.

The reference-schema pkl export (`export_cyclegan_pkl`) waits for the pkl
loaders (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

from img2img_turbo_tpu_torch.training.paired import TrainState

_NAME = re.compile(r"^(\d+)\.pt$")


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                os.listdir(directory)) if m)


def _tensors(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in d.items()}


def save_train_state(directory: str, step: int, state: TrainState,
                     max_to_keep: int = 3) -> str:
    """Write `state` as checkpoint `step` of `directory` (created if
    missing) and delete all but the newest `max_to_keep`. Returns the
    file's path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{int(step)}.pt")
    tmp = path + ".tmp"
    torch.save({"gen": _tensors(state.gen), "disc": _tensors(state.disc),
                "disc_sn": _tensors(state.disc_sn),
                "gen_opt": state.gen_opt.state_dict(),
                "disc_opt": state.disc_opt.state_dict(),
                "step": int(state.step)}, tmp)
    os.replace(tmp, path)
    for old in _steps(directory)[:-max_to_keep]:
        os.remove(os.path.join(directory, f"{old}.pt"))
    return path


def latest_step(directory: str) -> Optional[int]:
    """The newest checkpoint's step in `directory`, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


@torch.no_grad()
def restore_train_state(directory: str, state: TrainState,
                        step: Optional[int] = None) -> TrainState:
    """Load checkpoint `step` (the newest when None) of `directory` into
    `state` in place: the same keys and shapes, the values copied into its
    own tensors (which its optimizers hold), the optimizers' moments and
    counts loaded. Returns `state`."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    saved = torch.load(os.path.join(directory, f"{int(step)}.pt"),
                       map_location="cpu", weights_only=True)
    for part in ("gen", "disc", "disc_sn"):
        have, got = getattr(state, part), saved[part]
        if set(have) != set(got):
            raise ValueError(f"checkpoint {step}: {part} keys differ from "
                             f"the state's: {sorted(set(have) ^ set(got))}")
        for k, v in got.items():
            if have[k].shape != v.shape:
                raise ValueError(f"checkpoint {step}: {part} {k} is "
                                 f"{tuple(v.shape)}, the state's "
                                 f"{tuple(have[k].shape)}")
            have[k].copy_(v)
    state.gen_opt.load_state_dict(saved["gen_opt"])
    state.disc_opt.load_state_dict(saved["disc_opt"])
    state.step = saved["step"]
    return state
