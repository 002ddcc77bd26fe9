"""The model axis: the UNet's and the VAE's weights sharded over the model
ranks (counterpart of `img2img_turbo_tpu/parallel/mesh.py:162-201`,
`_tp_spec_for` and `param_shardings`).

JAX's rule, on the port's diffusers names and torch layouts (a JAX `(in,
out)` linear kernel is the port's `(out, in)` weight, a JAX HWIO conv
kernel the port's `(Co, Ci, kh, kw)`):
- attention `to_q` / `to_k` / `to_v` and the GEGLU `proj` are sharded on
  their output dim (port dim 0);
- attention `to_out` and the feed-forward `out` (`ff.net.2`) on their input
  dim (port dim 1); their biases stay whole;
- every 4-D conv weight whose output channels are even is sharded on them
  (port dim 0);
- everything else stays whole on every rank (norms, `proj_in` /
  `proj_out`, the time embedding, `time_emb_proj`), as does a dim that does
  not divide by the model axis.

Where the port departs from JAX's layout, and why:
(a) the GEGLU `proj`'s output is `[value | gate]` (split at
    `img2img_turbo_tpu/models/layers.py:801-803`); JAX's contiguous shard
    would put all of the value on the first rank and all of the gate on
    the second. Rank r holds `cat(value_r, gate_r)`, so its gated K3 launch
    computes slice r of `value * gelu(gate)`, which slice r of `out`'s input
    dim takes; its bias is sliced alike (JAX keeps every 1-D leaf whole);
(b) an attention layer whose heads do not divide by n_model stays whole on
    every rank (q, k, v and out, with their biases): ranks that exchange
    only whole heads cannot split one (XLA splits SD-Turbo's 5-head
    level-0 layers 160/160 and reshards at the head reshape). The VAE's
    two mid-block attentions have one head of the mid block's width
    (`vae_head_dim`), so they are whole at every n_model above 1, where
    JAX shards their to_q / to_k / to_v and to_out kernels (its rule keeps
    every 1-D leaf whole) and XLA splits the one head;
(c) a sharded conv's bias is sharded with its output channels (JAX keeps
    every 1-D leaf whole): each rank stores the slice it adds;
(d) `conv_in` stays whole on every rank. It is a trainable of both
    training steps (the JAX steps pop it out of the frozen tree,
    `img2img_turbo_tpu/training/paired.py:54-59`, so JAX's dry run keeps it
    replicated with the rest of the trainable state): a whole conv_in needs
    no collective and its gradient is whole where it is computed. It is 4
    channels in, so in serving its slice saves little and would cost a
    gather of its output;
(e) the VAE decoder's skip convs (`decoder.skip_conv_1` .. `_4`) stay whole
    on every rank. They are trainables of both training steps too (the JAX
    steps pop them out of the frozen tree, `img2img_turbo_tpu/training/
    paired.py:56-58`), as conv_in is under (d). Where a skip conv rides a
    column-parallel conv's epilogue, the rank takes its output columns of
    the skip weight through `model_scatter` (`models/layers.py`), so the
    skip conv's gradient is whole on every rank.

Serving keeps the VAE whole (`ServingEngine(mesh=...)` shards the UNet
alone): the JAX serving engine has no model axis, and a sharded VAE would
add about 1.57 GB of gathers to every 512x512 request (counted from its
shapes at two ranks) to save about 0.08 GB of bf16 weights a rank.
Training shards every VAE of the run (`training/runner.
shard_for_training`), as the JAX dry run shards its frozen tree
(`__graft_entry__.py:148-163`).

`shard_module` applies the rule to a module (a UNet or a VAE) in place,
marks each module it sharded (`tp_sharded`) and keeps the rule's dims on
the model (`tp_specs`); the layer functions of `models/layers.py` read the
mark when they are given the mesh. `gather_state_dict` puts a sharded
module's whole state dict back together on every model rank.

Training: the trainables stay whole and the same on every model rank.
Where one replaces or adapts a sharded base weight, the rank takes its
slice through the model axis's operators (`parallel/mesh.py`), so that
the gradient reaching the whole tensor is whole on every rank:
`shard_lora` slices a LoRA pair's factors (the factor on the sharded side
through `model_scatter`, the shared one through `model_copy`), so no rank
forms the whole delta of a sharded weight.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn as nn

from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod

_QKV = (".to_q.weight", ".to_k.weight", ".to_v.weight")   # bias-free
_OUT = ".to_out.0.weight"
_GEGLU = (".ff.net.0.proj.weight", ".ff.net.0.proj.bias")
_FF_OUT = ".ff.net.2.weight"
_SKIP = ".decoder.skip_conv_"


def _geglu(name: str) -> bool:
    """The GEGLU proj's weight or bias, or the proj module itself."""
    return ("." + name).endswith(_GEGLU) or ("." + name).endswith(
        ".ff.net.0.proj")


def head_dim(cfg) -> int:
    """The UNet's per-head width, the same at every level (unet.py:395)."""
    return cfg.block_out_channels[0] // cfg.attention_head_dim[0]


def vae_head_dim(cfg) -> int:
    """The VAE's per-head width: its mid attentions' one head spans the
    mid block's channels (`models/vae.py`, `VAEAttention`)."""
    return cfg.block_out_channels[-1]


def _is_conv_bias(name: str) -> bool:
    """A conv's bias by its module's name: conv_in, conv1, conv2,
    conv_shortcut, the samplers' conv, conv_out, the TwinConv halves, the
    VAE's quant_conv and post_quant_conv (not the GroupNorm
    conv_norm_out)."""
    if not name.endswith(".bias"):
        return False
    module = name[:-len(".bias")].rsplit(".", 1)[-1]
    return (module.startswith("conv") and module != "conv_norm_out") or \
        module.endswith("quant_conv")


def tp_spec_for(name: str, shape: Sequence[int], n_model: int,
                head_dim: int = 64) -> Optional[int]:
    """The dim of the port's tensor `name` (a diffusers UNet or VAE name)
    of the whole `shape` that a model axis of n_model ranks shards, or None
    when every rank holds it whole. head_dim: the model's per-head width
    (64 in SD-Turbo's UNet, `head_dim`; the VAE's `vae_head_dim`), which
    decides departure (b)."""
    key = "." + name
    if n_model == 1 or name.startswith("conv_in.") or _SKIP in key:
        return None                                     # (d), (e)
    if key.endswith(_QKV) or key.endswith(_OUT):
        # (b) whole heads only: to_q's outputs, to_out's inputs
        width = shape[1] if key.endswith(_OUT) else shape[0]
        if width % head_dim or (width // head_dim) % n_model:
            return None
        return 1 if key.endswith(_OUT) else 0
    if key.endswith(_GEGLU):
        # (a) each rank a slice of the value and the same slice of the gate
        return 0 if shape[0] % (2 * n_model) == 0 else None
    if key.endswith(_FF_OUT):
        return 1 if shape[1] % n_model == 0 else None
    if len(shape) == 4 or (len(shape) == 1 and _is_conv_bias(name)):
        # JAX's conv rule (an even Co, then one that divides), and (c)
        co = shape[0]
        return 0 if co % 2 == 0 and co % n_model == 0 else None
    return None


def param_shardings(state_dict: Mapping[str, object], n_model: int,
                    head_dim: int = 64) -> Dict[str, Optional[int]]:
    """{name: the sharded dim of the port's tensor, or None} for every
    tensor of a UNet or VAE state dict (tensors, or anything with a
    `.shape`)."""
    return {k: tp_spec_for(k, tuple(v.shape), n_model, head_dim)
            for k, v in state_dict.items()}


def _slice(name: str, t: torch.Tensor, dim: Optional[int], m: int, n: int):
    if dim is None:
        return t
    return mesh_mod.model_part(t, m, n, dim, _geglu(name))


def shard_state_dict(state_dict: Mapping[str, torch.Tensor], mesh,
                     head_dim: int = 64) -> Dict[str, torch.Tensor]:
    """This model rank's tensors of a whole UNet or VAE state dict: its
    slice of every sharded tensor, the others as they are."""
    specs = param_shardings(state_dict, mesh.n_model, head_dim)
    return {k: _slice(k, v, specs[k], mesh.model_rank, mesh.n_model)
            for k, v in state_dict.items()}


def unshard_state_dict(shards: List[Mapping[str, torch.Tensor]],
                       specs: Mapping[str, Optional[int]]
                       ) -> Dict[str, torch.Tensor]:
    """The whole state dict from every model rank's `shard_state_dict`, in
    model-rank order, and the whole's `param_shardings`: its exact inverse
    (a shard's shape alone cannot say whether it is a slice)."""
    out = {}
    for k, dim in specs.items():
        parts = [s[k] for s in shards]
        if dim is None:
            out[k] = parts[0]
        elif _geglu(k):
            halves = [p.chunk(2, dim=0) for p in parts]
            out[k] = torch.cat([h[0] for h in halves] + [h[1] for h in halves])
        else:
            out[k] = torch.cat(parts, dim=dim)
    return out


@torch.no_grad()
def shard_module(model: nn.Module, mesh, head_dim: int = 64) -> nn.Module:
    """`model` (a whole UNet or VAE, before `prepare_kernels`; head_dim its
    per-head width) holding only this model rank's shards, in place: each
    sharded parameter is replaced by a copy of its slice (the whole is
    freed with its last reference), each module whose parameters were
    sliced is marked `tp_sharded`, and the model keeps the rule's dims by
    parameter name (`tp_specs`)."""
    if mesh is None or mesh.n_model == 1:
        return model
    whole = dict(model.named_parameters())
    specs = param_shardings(whole, mesh.n_model, head_dim)
    local = shard_state_dict(whole, mesh, head_dim)
    for name, p in whole.items():
        if specs[name] is None:
            continue
        owner, attr = name.rsplit(".", 1)
        module = model.get_submodule(owner)
        part = local[name].detach()
        setattr(module, attr, nn.Parameter(part,
                                           requires_grad=p.requires_grad))
        module.tp_sharded = True
    model.tp_specs = specs
    return model


@torch.no_grad()
def gather_state_dict(model: nn.Module, mesh) -> Dict[str, torch.Tensor]:
    """The whole state dict of `model`, which `shard_module` sharded over
    the model axis of `mesh`, on every rank of the model group: each
    sharded tensor's parts gathered over the model ranks (one collective
    a tensor, so every rank of the group must call it) and put back by
    `unshard_state_dict`. A module that holds no shards gives its own
    state dict."""
    specs = getattr(model, "tp_specs", None)
    sd = model.state_dict()
    if specs is None or mesh is None or mesh.n_model == 1:
        return sd
    n = mesh.n_model
    dims = {k: specs.get(k) for k in sd}
    shards = [{} for _ in range(n)]
    for k, v in sd.items():
        parts = ([v] * n if dims[k] is None else
                 mesh_mod.model_gather(v, mesh, dims[k]).chunk(n, dims[k]))
        for shard, part in zip(shards, parts):
            shard[k] = part
    return unshard_state_dict(shards, dims)


def shard_lora(name: str, a: torch.Tensor, b: torch.Tensor,
               dim: Optional[int], mesh):
    """This model rank's factors of the LoRA pair (a (kh, kw, in, r) or
    (in, r), b (r, out)) that adapts module `name`, whose weight the rule
    shards on `dim` (None: whole): on the output dim (0) b's columns are
    sliced (the GEGLU proj's by departure (a)'s layout) and a is shared;
    on the input dim (1, a linear) a's rows are sliced and b is shared.
    The slice goes through `model_scatter` and the shared factor through
    `model_copy`, so the factors' gradients are whole and the same on
    every rank; `lora.lora_delta` of the pair is the slice of the whole
    delta that this rank's weight slice takes."""
    if dim is None:
        return a, b
    if dim == 0:
        return (mesh_mod.model_copy(a, mesh),
                mesh_mod.model_scatter(b, mesh, 1, halves=_geglu(name)))
    return (mesh_mod.model_scatter(a, mesh, a.ndim - 2),
            mesh_mod.model_copy(b, mesh))
