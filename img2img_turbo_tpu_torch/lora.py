"""LoRA on the port's modules (counterpart of `img2img_turbo_tpu/lora.py`).

Adapters are plain dictionaries that keep the JAX package's layout, so the
tests feed both packages the same numbers: {"rank", "alpha", "modules":
{diffusers module name: {"a", "b"}}}, with a (kh, kw, in, r) for a conv or
(in, r) for a linear, and b (r, out). Target matching is peft's: a module
name equals a target or ends with "." + target (`matches_target`).

`merge_lora` is differentiable: the delta alpha/r * A.B is formed in fp32
and added to the fp32 base weight, and the sum is cast to the compute
dtype (`lora.py:263-290`). `swap_params` puts such tensors in place of a
module's parameters for the length of a `with` block, so that a forward,
its backward and any activation checkpointing recompute inside the block
all read the merged weights.

`lora_from_torch_state_dict` and `overlay_base_weights` read the
reference's pkl checkpoints (lora.py:307-386): peft's
`<module>.lora_{A,B}[.<adapter>].weight` keys into this layout, and the
plain weights a checkpoint retrains (conv_in, the skip convs, under
`.base_layer.` where peft wraps them) onto a module.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, Iterator, List, Optional, Sequence

import torch
import torch.nn as nn

from img2img_turbo_tpu_torch.parallel import tensor as tensor_mod
from img2img_turbo_tpu_torch.utils import profiling

# reference target lists (pix2pix_turbo.py:137-152)
PIX2PIX_UNET_TARGETS = (
    "to_k", "to_q", "to_v", "to_out.0", "conv", "conv1", "conv2",
    "conv_shortcut", "conv_out", "proj_in", "proj_out", "ff.net.2",
    "ff.net.0.proj")
PIX2PIX_VAE_TARGETS = (
    "conv1", "conv2", "conv_in", "conv_shortcut", "conv", "conv_out",
    "skip_conv_1", "skip_conv_2", "skip_conv_3", "skip_conv_4",
    "to_k", "to_q", "to_v", "to_out.0")
# CycleGAN-Turbo's (cyclegan_turbo.py:52, 99): the UNet grep, split by
# module name into three adapters (pipelines/cyclegan.py)
CYCLEGAN_UNET_GREP = (
    "to_k", "to_q", "to_v", "to_out.0", "conv", "conv1", "conv2", "conv_in",
    "conv_shortcut", "conv_out", "proj_out", "proj_in", "ff.net.2",
    "ff.net.0.proj")
CYCLEGAN_VAE_TARGETS = PIX2PIX_VAE_TARGETS


def matches_target(name: str, targets: Sequence[str]) -> bool:
    """peft semantics: the name equals a target or ends with '.<target>'."""
    return any(name == t or name.endswith("." + t) for t in targets)


def weight_modules(model: nn.Module) -> Dict[str, nn.Module]:
    """{diffusers name: module} of every conv and linear of `model`."""
    return {n: m for n, m in model.named_modules()
            if isinstance(m, (nn.Conv2d, nn.Linear))}


def targeted(model: nn.Module, targets: Sequence[str]) -> list:
    """Sorted names of the modules LoRA adapts."""
    return sorted(n for n in weight_modules(model)
                  if matches_target(n, targets))


def init_lora(model: nn.Module, rank: int, targets: Sequence[str],
              generator: torch.Generator, alpha: float = 8.0) -> Dict:
    """Gaussian A with std 1/rank, B = 0 (so the merge starts at the base
    weights), in fp32 on the generator's device, for every targeted
    module, drawn in sorted name order."""
    dev = generator.device
    modules = {}
    mods = weight_modules(model)
    for name in targeted(model, targets):
        w = mods[name].weight
        if w.ndim == 4:
            cout, cin, kh, kw = w.shape
            a_shape = (kh, kw, cin, rank)
        else:
            cout, cin = w.shape
            a_shape = (cin, rank)
        a = torch.randn(a_shape, generator=generator, device=dev) / rank
        modules[name] = {"a": a, "b": torch.zeros(rank, cout, device=dev)}
    return {"rank": rank, "alpha": float(alpha), "modules": modules}


def lora_delta(a, b, weight_shape):
    """Dense delta in the module's layout (OIHW for a conv, (out, in) for a
    linear), fp32, without the alpha/rank scale."""
    a, b = a.float(), b.float()
    if len(weight_shape) == 4:
        return torch.einsum("hwir,ro->oihw", a, b)
    return (a @ b).t()


def merge_lora(base: Dict[str, torch.Tensor], lora: Dict, scale=1.0,
               dtype=None, specs: Optional[Dict] = None, tp=None
               ) -> Dict[str, torch.Tensor]:
    """{"<name>.weight": W + scale * alpha/rank * delta} for every adapted
    module, from `base` ({"<name>.weight": weight}): the scaled delta is
    formed in fp32 and cast to W's dtype before the add, and the sum is
    cast to `dtype` when given. `scale` may be a 0-d tensor (the sketch
    path's runtime r: one merge serves every r, read on the device).
    Differentiable in the factors and in W.

    Under a model axis, `base` holds this rank's shards of a UNet and
    `specs` its sharded dims by parameter name (the model's `tp_specs`,
    `parallel.tensor.shard_module`): each pair is sliced to its weight's
    shard (`parallel.tensor.shard_lora`, through the mesh `tp`), so a
    rank forms only its slice of each delta."""
    s = lora["alpha"] / lora["rank"]
    out = {}
    for name, entry in lora["modules"].items():
        w = base[name + ".weight"]
        a, b = entry["a"], entry["b"]
        if specs is not None:
            a, b = tensor_mod.shard_lora(name, a, b, specs[name + ".weight"],
                                         tp)
        merged = w + (scale * s * lora_delta(a, b, w.shape)).to(w.dtype)
        out[name + ".weight"] = merged if dtype is None else merged.to(dtype)
    profiling.count("lora_merged_weights", len(out))
    return out


def merge_multi(base: Dict[str, torch.Tensor], loras: Sequence[Dict],
                scale=1.0, dtype=None, specs: Optional[Dict] = None,
                tp=None) -> Dict[str, torch.Tensor]:
    """Several adapters merged one after the other (CycleGAN's encoder /
    decoder / others trio, lora.py:293): {"<name>.weight": merged} for
    every module any of them adapts, cast to `dtype` when given; on a
    model axis's shards with `specs` and `tp`, as `merge_lora`."""
    out: Dict[str, torch.Tensor] = {}
    for lora in loras:
        out.update(merge_lora({**base, **out}, lora, scale, specs=specs,
                              tp=tp))
    return out if dtype is None else {k: v.to(dtype) for k, v in out.items()}


@contextlib.contextmanager
def swap_params(model: nn.Module,
                tensors: Dict[str, torch.Tensor]) -> Iterator[nn.Module]:
    """Within the block, `model`'s parameters named in `tensors` are those
    tensors (which may carry autograd history); the originals come back on
    exit. Run the forward and the backward inside the block, so that
    activation checkpointing recomputes with the same weights. Each tensor
    must have its parameter's shape (a sharded model's: its shard's)."""
    mods = dict(model.named_modules())
    saved = []
    try:
        for key, t in tensors.items():
            mod_name, leaf = key.rsplit(".", 1) if "." in key else ("", key)
            mod = mods[mod_name]
            if leaf not in mod._parameters:
                raise KeyError(f"{key} is not a parameter of the model")
            old = mod._parameters[leaf]
            if old is not None and t.shape != old.shape:
                raise ValueError(f"{key}: {tuple(t.shape)} in place of the "
                                 f"parameter's {tuple(old.shape)}")
            saved.append((mod, leaf, mod._parameters[leaf]))
            mod._parameters[leaf] = t
        yield model
    finally:
        for mod, leaf, p in reversed(saved):
            mod._parameters[leaf] = p


# ---------------------------------------------------------------------------
# Reference-pkl ingestion (schemas: pix2pix_turbo.py:221-229,
# train_cyclegan_turbo.py:293-307)
# ---------------------------------------------------------------------------

_LORA_RE = re.compile(r"^(.*)\.lora_([AB])(?:\.([^.]+))?\.weight$")


def lora_from_torch_state_dict(sd: Dict[str, torch.Tensor], rank: int,
                               alpha: Optional[float] = None,
                               adapter: Optional[str] = None) -> Dict:
    """An adapter from peft keys `<module>.lora_{A,B}.<adapter>.weight`, or
    `<module>.lora_{A,B}.weight` as `get_peft_model_state_dict` writes them;
    other keys are ignored, as are other adapters' when `adapter` is given.
    lora_A (r, in, kh, kw) or (r, in) -> a (kh, kw, in, r) or (in, r);
    lora_B (out, r, 1, 1) or (out, r) -> b (r, out); fp32. alpha defaults
    to peft's 8.0 (so the scale is 8 / rank)."""
    modules: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in sd.items():
        m = _LORA_RE.match(k)
        if m is None:
            continue
        name, ab, name_adapter = m.groups()
        if adapter is not None and name_adapter is not None \
                and name_adapter != adapter:
            continue
        v = v.detach().float()
        if ab == "A":
            t = v.permute(2, 3, 1, 0) if v.ndim == 4 else v.t()
        else:
            t = (v[:, :, 0, 0] if v.ndim == 4 else v).t()
        entry = modules.setdefault(name.replace(".base_layer", ""), {})
        entry["a" if ab == "A" else "b"] = t.contiguous()
    for name, entry in modules.items():
        if set(entry) != {"a", "b"}:
            raise ValueError(f"incomplete LoRA pair: {name}")
    return {"rank": rank, "alpha": float(alpha if alpha is not None else 8.0),
            "modules": modules}


def overlay_base_weights(model: nn.Module, sd: Dict[str, torch.Tensor]
                         ) -> List[str]:
    """Copy the plain (non-LoRA) conv and linear weights and biases of a
    reference checkpoint onto `model`, in place: the retrained conv_in and
    skip convs (pix2pix_turbo.py:226-228), `.base_layer.` stripped. Keys
    naming no conv or linear of the model are skipped. Returns the keys
    applied."""
    mods = weight_modules(model)
    applied = []
    with torch.no_grad():
        for k, v in sd.items():
            if ".lora_" in k or not k.endswith((".weight", ".bias")):
                continue
            name, field = k.rsplit(".", 1)
            name = name.replace(".base_layer", "")
            if name not in mods:
                continue
            p = getattr(mods[name], field)
            if p is None:
                raise ValueError(f"{k}: {name} has no {field}")
            p.copy_(v)
            applied.append(k)
    return applied
