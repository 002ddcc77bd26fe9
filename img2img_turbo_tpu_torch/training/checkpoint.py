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

`export_pix2pix_pkl` and `export_cyclegan_pkl` write the reference's
own checkpoint schema (a `torch.save` pickle of adapter state dicts in
peft's key layout) from a run's trainables, key for key and tensor for
tensor what the JAX package's exporters write
(`pipelines/pix2pix.py:303 save_model`, `training/checkpoint.py:66`).
Loading such a file back waits for the pkl loaders (ROADMAP Queue 1
item 4).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

from img2img_turbo_tpu_torch import lora as lora_mod
from img2img_turbo_tpu_torch.training.paired import TrainState, lora_modules
from img2img_turbo_tpu_torch.weights.torch_export import (
    lora_state_dict, peft_wrap_state_dict)

_NAME = re.compile(r"^(\d+)\.pt$")


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                os.listdir(directory)) if m)


def _tensors(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in d.items()}


def save_train_state(directory: str, step: int, state: TrainState,
                     max_to_keep: int = 3, mesh=None) -> str:
    """Write `state` as checkpoint `step` of `directory` (created if
    missing) and delete all but the newest `max_to_keep`. Returns the
    file's path. With a data mesh (`parallel.mesh.DataMesh`), whose ranks
    hold the same state, rank 0 alone writes and every rank then waits at
    a barrier, so no rank reads a checkpoint before it is whole."""
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    path = os.path.join(directory, f"{int(step)}.pt")
    if mesh is None or mesh.is_main:
        _write_state(directory, path, state, max_to_keep)
    mesh_mod.barrier(mesh)
    return path


def _write_state(directory: str, path: str, state: TrainState,
                 max_to_keep: int) -> None:
    os.makedirs(directory, exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"gen": _tensors(state.gen), "disc": _tensors(state.disc),
                "disc_sn": _tensors(state.disc_sn),
                "gen_opt": state.gen_opt.state_dict(),
                "disc_opt": state.disc_opt.state_dict(),
                "step": int(state.step)}, tmp)
    os.replace(tmp, path)
    for old in _steps(directory)[:-max_to_keep]:
        os.remove(os.path.join(directory, f"{old}.pt"))


def latest_step(directory: str) -> Optional[int]:
    """The newest checkpoint's step in `directory`, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


@torch.no_grad()
def restore_train_state(directory: str, state: TrainState,
                        step: Optional[int] = None, mesh=None) -> TrainState:
    """Load checkpoint `step` (the newest when None) of `directory` into
    `state` in place: the same keys and shapes, the values copied into its
    own tensors (which its optimizers hold), the optimizers' moments and
    counts loaded. Returns `state`. With a mesh every rank reads the
    file, then a fingerprint all-reduce over each axis checks that all
    ranks restored the same state (`parallel.mesh.assert_replicated`). The
    state is whole on every rank under a model axis too (only the frozen
    UNet is sharded), so no checkpoint holds a slice."""
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
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
    for axis in ("data", "model"):
        mesh_mod.assert_replicated({"restored state": state}, mesh,
                                   axis=axis)
    return state


# ---------------------------------------------------------------------------
# Reference-schema pkl export
# ---------------------------------------------------------------------------


def _own(gen: Dict[str, torch.Tensor], part: str) -> Dict[str, torch.Tensor]:
    """The trainable parameters of model `part` ("<part>:<name>" keys)."""
    return {k.split(":", 1)[1]: v for k, v in gen.items()
            if k.startswith(part + ":")}


def export_pix2pix_pkl(outf: str, gen: Dict[str, torch.Tensor], meta
                       ) -> None:
    """The reference pix2pix-turbo pkl (pix2pix_turbo.py:221-229) from a
    paired run's trainables: the UNet LoRA under adapter "default" with
    the trained conv_in, the VAE LoRA under "vae_skip" with the skip convs'
    weights under `.base_layer.` (peft wraps those targeted convs), the
    target lists and ranks."""
    sd_unet = lora_state_dict(lora_modules(gen, "unet_lora"), "default")
    sd_unet.update({k: v.detach().float().cpu().contiguous()
                    for k, v in _own(gen, "unet").items()})
    sd_vae = lora_state_dict(lora_modules(gen, "vae_lora"), "vae_skip")
    for k, v in _own(gen, "vae").items():
        name, field = k.rsplit(".", 1)
        sd_vae[f"{name}.base_layer.{field}"] = \
            v.detach().float().cpu().contiguous()
    torch.save({
        "unet_lora_target_modules": list(lora_mod.PIX2PIX_UNET_TARGETS),
        "vae_lora_target_modules": list(lora_mod.PIX2PIX_VAE_TARGETS),
        "rank_unet": meta.rank_unet,
        "rank_vae": meta.rank_vae,
        "state_dict_unet": sd_unet,
        "state_dict_vae": sd_vae,
    }, outf)


def export_cyclegan_pkl(outf: str, gen: Dict[str, torch.Tensor],
                        vaes: Dict[str, torch.nn.Module], meta,
                        mesh=None) -> None:
    """The reference CycleGAN-Turbo pkl (train_cyclegan_turbo.py:293-307)
    from an unpaired run's trainables and its two VAE modules (`vaes`,
    {"vae_a2b", "vae_b2a"}): the three UNet adapters' state dicts (no
    adapter name in the keys) with their sorted target lists, and
    sd_vae_enc = sd_vae_dec = both whole VAEs under "vae." and "vae_b2a.",
    the trained skip convs in place, every targeted module peft-wrapped
    (`.base_layer.`, LoRA under "vae_skip"), so that the reference's strict
    `load_state_dict` takes them.

    Under a model axis (`mesh` with n_model above 1) the VAEs hold this
    rank's shards (`runner.shard_for_training`): every rank calls the
    export, each VAE's shards are gathered over the model group into the
    whole (`parallel.tensor.gather_state_dict`), and the main process
    alone writes the file."""
    from img2img_turbo_tpu_torch.parallel import tensor as tensor_mod
    from img2img_turbo_tpu_torch.pipelines.cyclegan import ADAPTERS
    whole = {part: tensor_mod.gather_state_dict(vaes[part], mesh)
             for part in ("vae_a2b", "vae_b2a")}
    if mesh is not None and not mesh.is_main:
        return
    unet = {a: lora_modules(gen, f"unet_lora:{a}") for a in ADAPTERS}
    sd_vae: Dict[str, torch.Tensor] = {}
    for prefix, part in (("vae.", "vae_a2b"), ("vae_b2a.", "vae_b2a")):
        sd = {**whole[part], **_own(gen, part)}
        sd = peft_wrap_state_dict(sd, lora_modules(gen, part + "_lora"),
                                  lora_mod.CYCLEGAN_VAE_TARGETS, "vae_skip")
        sd_vae.update({prefix + k: v for k, v in sd.items()})
    torch.save({
        "l_target_modules_encoder": sorted(unet["default_encoder"]),
        "l_target_modules_decoder": sorted(unet["default_decoder"]),
        "l_modules_others": sorted(unet["default_others"]),
        "rank_unet": meta.rank_unet,
        "sd_encoder": lora_state_dict(unet["default_encoder"]),
        "sd_decoder": lora_state_dict(unet["default_decoder"]),
        "sd_other": lora_state_dict(unet["default_others"]),
        "rank_vae": meta.rank_vae,
        "vae_lora_target_modules": list(lora_mod.CYCLEGAN_VAE_TARGETS),
        "sd_vae_enc": sd_vae,
        "sd_vae_dec": sd_vae,
    }, outf)
