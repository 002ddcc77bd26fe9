"""Data and model parallelism on torch.distributed (counterpart of
`img2img_turbo_tpu/parallel/mesh.py`).

The JAX package runs a `(data, model)` device mesh (`mesh.py:49-66`): its
device `grid[d, m]` is `devices.reshape(n_data, n_model)`. Each data shard
runs the single-device program, Pallas kernels included, on its contiguous
rows of the global batch, and the training steps `pmean` their losses and
gradients over the data axis before every optimizer update; a model axis
above 1 shards the UNet's weights by `_tp_spec_for` (`mesh.py:162-201`,
here `parallel/tensor.py`). The port keeps those semantics with one
process a rank:

- `make_mesh(n_data, n_model)` gives this rank its `DataMesh`: global rank
  `d * n_model + m` is JAX's `grid[d, m]`; `rank` / `world` are the data
  axis (d, n_data) and `model_rank` / `n_model` the model axis, each axis
  with a process group of its own (`mesh_groups`);
- `shard_batch` takes this rank's contiguous rows of a global batch (the
  rows JAX's `P(data)` places on data shard d: the ranks of one model group
  get the same rows); `gather_batch` puts the global batch back together on
  every rank;
- `pmean` averages a list or dict of tensors over the data axis in one
  flat fp32 bucket with one all-reduce (the paired generator alone has
  hundreds of LoRA leaves);
- `replicate` broadcasts a state from data rank 0; `assert_replicated`
  checks through one all-reduce of fingerprints that every rank of the data
  axis holds the same tensors (frozen modules are built on each rank from
  the same seed or files and checked, never broadcast);
- the model axis's four operators, each a `torch.autograd.Function` over
  the model group, which the sharded UNet's layers call
  (`models/layers.py`): `model_copy` (identity forward, a SUM all-reduce
  of the gradient backward), `model_reduce` (a SUM all-reduce forward,
  identity backward), `model_gather` (an all-gather forward, this rank's
  slice of the gradient backward) and `model_scatter` (this rank's slice
  forward, an all-gather of the gradient backward). Under `no_grad`
  (serving) they run their forward alone.

The backend is NCCL when each rank has a CUDA card of its own and gloo
otherwise (ranks sharing a card, or on the CPU). gloo implements only
`broadcast` and `all_reduce` on CUDA tensors, so every collective here is
built from those two: a gather is a SUM all-reduce of a zeroed global
buffer in which each rank wrote its part (as bytes, so that it is exact
for every dtype and a -0.0 keeps its sign); the model axis's sum adds the
ranks' partial results in fp32. Nothing here falls back to another device
or catches a collective's failure.

`torchrun --nproc_per_node N` runs N ranks. Serving: each builds its
`ServingEngine(mesh=make_mesh(n_data, n_model))` (N = n_data * n_model),
which shards the UNet over the model axis. Training: both training CLIs'
`--tensor_parallel n_model` make that mesh (`distributed(n_model=...)`),
and both steps take it (`training/paired.py`). Under a model axis training
shards the VAE too, serving keeps it whole on every rank
(`parallel/tensor.py`); the sketch mode is not ported (it raises).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Iterable, List, Mapping, Optional

import torch
import torch.distributed as dist

@dataclasses.dataclass
class DataMesh:
    """One rank's view of the mesh. `rank` and `world` are its place on the
    data axis and that axis's size, `group` that axis's process group (None
    when the data axis has one rank, or in a one-process run without a
    process group: every data collective is then the identity).
    `model_rank`, `n_model` and `model_group` are the model axis's (the
    group is None when n_model is 1). `stats` counts the all-reduces of
    `pmean` and of the model axis's collectives ("calls", "bytes") and,
    when `timed` is set, their wall time ("seconds": the device
    synchronised before and after each)."""
    rank: int
    world: int
    device: torch.device
    group: Optional[object] = None
    backend: Optional[str] = None
    timed: bool = False
    stats: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"calls": 0, "bytes": 0, "seconds": 0.0})
    model_rank: int = 0
    n_model: int = 1
    model_group: Optional[object] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0 and self.model_rank == 0

    def reset_stats(self) -> None:
        self.stats.update(calls=0, bytes=0, seconds=0.0)


def local_device(device=None) -> torch.device:
    """`device` when given, else this rank's CUDA card: LOCAL_RANK modulo
    the cards present (ranks of one host share cards round robin). Without
    a card the caller must pass device="cpu"."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                        % torch.cuda.device_count())


def choose_backend(device, ranks_per_host: Optional[int] = None) -> str:
    """"nccl" when `device` is a CUDA card and each of the host's ranks
    (`ranks_per_host`, else LOCAL_WORLD_SIZE, else 1) has a card of its
    own, else "gloo"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    n = ranks_per_host or int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    return "nccl" if n <= torch.cuda.device_count() else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device=None,
                     backend: Optional[str] = None) -> bool:
    """Join the process group and return the main-process flag
    (mesh.py:29-41). The group is made when `num_processes` is given (its
    address "host:port", or any init URL such as "tcp://..." or
    "file://...", and this rank's `process_id`) or when torchrun's
    environment names one (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT:
    "env://"); otherwise, and when the group exists already, nothing is
    made. The backend follows `choose_backend(device)` unless given; with
    NCCL the rank's card becomes the current device."""
    if dist.is_initialized():
        return dist.get_rank() == 0
    if num_processes is None and "WORLD_SIZE" not in os.environ:
        return True
    world = int(num_processes if num_processes is not None
                else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    if coordinator_address is None:
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = "tcp://" + coordinator_address
    dev = local_device(device)
    backend = backend or choose_backend(
        dev, None if "LOCAL_WORLD_SIZE" in os.environ else world)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=url, world_size=world,
                            rank=rank)
    return rank == 0


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def mesh_groups(n_data: int, n_model: int):
    """(data groups, model groups) of a (n_data, n_model) mesh as lists of
    ranks: rank d * n_model + m is JAX's `grid[d, m]` (mesh.py:65), so data
    group m is the grid's column m and model group d its row d."""
    data = [[d * n_model + m for d in range(n_data)] for m in range(n_model)]
    model = [[d * n_model + m for m in range(n_model)] for d in range(n_data)]
    return data, model


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device=None, group=None) -> DataMesh:
    """This rank's mesh over `group` (the default group when there is one;
    none in a one-process run), on `device` (`local_device`). n_data
    defaults to the group's size over n_model, and n_data * n_model must
    equal it. With n_model above 1 every rank of `group` must call this
    alike: it makes the data and model subgroups (`mesh_groups`), each
    collectively."""
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    world = dist.get_world_size(group) if group is not None else 1
    rank = dist.get_rank(group) if group is not None else 0
    if n_model < 1 or world % n_model:
        raise ValueError(f"n_model={n_model}: the model axis needs a "
                         f"divisor of the process group's {world} ranks")
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs "
                         f"{n_data * n_model} ranks; the process group has "
                         f"{world}")
    dev = local_device(device)
    backend = dist.get_backend(group) if group is not None else None
    if n_model == 1:
        return DataMesh(rank, world, dev, group, backend)
    ranks = dist.get_process_group_ranks(group)     # group rank -> global
    d, m = divmod(rank, n_model)
    data_groups, model_groups = mesh_groups(n_data, n_model)
    made = {}
    for kind, groups in (("data", data_groups if n_data > 1 else []),
                         ("model", model_groups)):
        for members in groups:
            g = dist.new_group([ranks[r] for r in members], backend=backend)
            if rank in members:
                made[kind] = g
    return DataMesh(d, n_data, dev, made.get("data"), backend,
                    model_rank=m, n_model=n_model,
                    model_group=made["model"])


def barrier(mesh: Optional[DataMesh]) -> None:
    """Wait for every rank (a one-element all-reduce over each axis, which
    every backend implements on every device: a rank passes the model
    axis's only once its model peers passed the data axis's)."""
    if mesh is None:
        return
    for group in (mesh.group, mesh.model_group):
        if group is not None:
            dist.all_reduce(torch.zeros(1, device=mesh.device), group=group)


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------


def _rows(x, mesh: DataMesh):
    b = x.shape[0]
    if b % mesh.world:
        raise ValueError(f"global batch {b} is not divisible by the "
                         f"{mesh.world} ranks of the data axis")
    n = b // mesh.world
    return x[mesh.rank * n:(mesh.rank + 1) * n]


def shard_batch(tree, mesh: Optional[DataMesh]):
    """This rank's contiguous rows of every batch-leading array (tensor or
    numpy) in a dict / list / tuple tree: rows [r*B/W, (r+1)*B/W) of a
    global batch B, which must divide by the world size W. Other leaves
    pass through; nothing is moved to a device."""
    if mesh is None or mesh.world == 1:
        return tree
    if isinstance(tree, Mapping):
        return {k: shard_batch(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(v, mesh) for v in tree)
    return _rows(tree, mesh) if hasattr(tree, "shape") else tree


def gather_batch(x: torch.Tensor, mesh: Optional[DataMesh]) -> torch.Tensor:
    """The global batch on every rank from each rank's rows `x` (every rank
    holding as many): a SUM all-reduce of the zeroed global buffer in which
    this rank wrote its rows, as bytes, so the result is exact for any
    dtype."""
    if mesh is None or mesh.group is None or mesh.world == 1:
        return x
    n = x.shape[0]
    out = torch.zeros((n * mesh.world,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[mesh.rank * n:(mesh.rank + 1) * n] = x
    dist.all_reduce(out.view(-1).view(torch.uint8), group=mesh.group)
    return out


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------


def _sum(buf: torch.Tensor, mesh: DataMesh, group) -> None:
    """SUM all-reduce of `buf` in place over `group`, counted (and timed
    when `mesh.timed`) in `mesh.stats`."""
    if mesh.timed and mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    dist.all_reduce(buf, group=group)
    if mesh.timed:
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        mesh.stats["seconds"] += time.perf_counter() - t0
    mesh.stats["calls"] += 1
    mesh.stats["bytes"] += buf.numel() * buf.element_size()


def pmean(tensors, mesh: Optional[DataMesh]):
    """The mean over the ranks of each tensor of a list, tuple or dict (same
    structure back, each tensor in its own dtype and shape), through one
    flat fp32 bucket and one SUM all-reduce. The identity without a group.
    With W ranks holding the same g, (W*g)/W is g exactly for W a power of
    two."""
    if mesh is None or mesh.group is None:
        return tensors
    items = list(tensors.items()) if isinstance(tensors, Mapping) \
        else list(enumerate(tensors))
    if not items:
        return tensors
    flat = torch.cat([t.detach().reshape(-1).to(device=mesh.device,
                                                dtype=torch.float32)
                      for _, t in items])
    _sum(flat, mesh, mesh.group)
    flat.div_(mesh.world)
    # each result a tensor of its own with its input's strides (autograd
    # gives some gradients in another memory order): a later reduction over
    # it, such as the optimizer's clipping norm, then sums in the same
    # order as over the input
    out, off = [], 0
    for _, t in items:
        n = t.numel()
        out.append(torch.empty_like(t).copy_(flat[off:off + n].view(t.shape)))
        off += n
    if isinstance(tensors, Mapping):
        return dict(zip((k for k, _ in items), out))
    return type(tensors)(out)


def pmean_pass(loss, auxes, grads, mesh: Optional[DataMesh]):
    """The DDP all-reduce of one optimize pass (training/paired.py:117-126):
    the loss, the gradients and every 0-d entry of the pass's aux
    dictionaries averaged over the ranks in one bucket; batch-leading aux
    (a pass's generated images, which feed this rank's discriminator
    passes) stays on its rank. Returns (loss, auxes, grads)."""
    if mesh is None or mesh.group is None:
        return loss, auxes, grads
    scalar = [(i, k) for i, a in enumerate(auxes) if isinstance(a, dict)
              for k, v in a.items() if torch.is_tensor(v) and v.ndim == 0]
    names = list(grads)
    reduced = pmean([loss] + [auxes[i][k] for i, k in scalar]
                    + [grads[n] for n in names], mesh)
    auxes = [dict(a) if isinstance(a, dict) else a for a in auxes]
    for (i, k), v in zip(scalar, reduced[1:1 + len(scalar)]):
        auxes[i][k] = v
    return reduced[0], auxes, dict(zip(names, reduced[1 + len(scalar):]))


# ---------------------------------------------------------------------------
# The model axis
# ---------------------------------------------------------------------------


def _gather(x: torch.Tensor, mesh: DataMesh, dim: int) -> torch.Tensor:
    """The model ranks' parts `x` (each as large) concatenated along `dim`
    in model-rank order, contiguous: a SUM all-reduce of the zeroed whole
    in which this rank wrote its part, as bytes, so exact for any dtype."""
    k = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = k * mesh.n_model
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(dim, mesh.model_rank * k, k).copy_(x)
    _sum(out.view(-1).view(torch.uint8), mesh, mesh.model_group)
    return out


def _reduce(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The sum of the model ranks' `x`, added in fp32 and rounded once to
    x's dtype."""
    acc = x.to(torch.float32, copy=True).contiguous()
    _sum(acc, mesh, mesh.model_group)
    return acc.to(x.dtype)


def model_part(x: torch.Tensor, m: int, n: int, dim: int, halves: bool):
    """Model rank m's slice of a whole `x` along `dim` over n ranks, a new
    contiguous tensor: the m-th of n equal parts, or with `halves` the
    m-th part of each of x's two halves, concatenated (the GEGLU `[value |
    gate]` layout of `parallel/tensor.py`, departure (a))."""
    pieces = x.chunk(2, dim) if halves else (x,)
    k = pieces[0].shape[dim] // n
    return torch.cat([p.narrow(dim, m * k, k) for p in pieces], dim)


def _part(x: torch.Tensor, mesh: DataMesh, dim: int, halves: bool):
    return model_part(x, mesh.model_rank, mesh.n_model, dim, halves)


def _whole(x: torch.Tensor, mesh: DataMesh, dim: int, halves: bool):
    """`_part`'s inverse over the model ranks: every rank's part gathered
    along `dim` and put back in the whole's layout."""
    out = _gather(x.contiguous(), mesh, dim)
    if not halves:
        return out
    pieces = out.chunk(2 * mesh.n_model, dim)   # value_0, gate_0, value_1, ...
    return torch.cat(pieces[0::2] + pieces[1::2], dim)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _gather(x.contiguous(), mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _part(g, ctx.mesh, ctx.dim, False), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, halves):
        ctx.mesh, ctx.dim, ctx.halves = mesh, dim, halves
        return _part(x, mesh, dim, halves)

    @staticmethod
    def backward(ctx, g):
        return _whole(g, ctx.mesh, ctx.dim, ctx.halves), None, None, None


def model_copy(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """`x`, a tensor every model rank holds whole (a column-parallel
    layer's input, a shared LoRA factor), as it is; backward, the sum of
    the ranks' partial gradients (fp32, rounded once), so that the
    gradient is whole and the same on every rank."""
    if mesh.n_model == 1:
        return x
    return _Copy.apply(x, mesh)


def model_reduce(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The sum of the model ranks' partial results `x` on every rank of
    the model group, added in fp32 and rounded once to x's dtype (a
    row-parallel product's partial sums); backward, the gradient as it
    is."""
    if mesh.n_model == 1:
        return x
    return _Reduce.apply(x, mesh)


def model_gather(x: torch.Tensor, mesh: DataMesh, dim: int = -1
                 ) -> torch.Tensor:
    """The model ranks' parts `x` (each as large) concatenated along `dim`
    in model-rank order, contiguous, on every rank of the model group: the
    channels of NHWC activations and of per-channel statistics (dim -1),
    the features of (B, S, C). Exact for any dtype. Backward, this rank's
    slice of the whole gradient, contiguous."""
    if mesh.n_model == 1:
        return x
    return _Gather.apply(x, mesh, dim % x.ndim)


def model_scatter(x: torch.Tensor, mesh: DataMesh, dim: int = -1,
                  halves: bool = False) -> torch.Tensor:
    """This model rank's contiguous slice of `x`, which every rank holds
    whole, along `dim` (with `halves`, its slice of each half: the GEGLU
    layout); backward, every rank's gradient slice gathered into the whole
    gradient, the same on every rank."""
    if mesh.n_model == 1:
        return x
    return _Scatter.apply(x, mesh, dim % x.ndim, halves)


# ---------------------------------------------------------------------------
# Replication
# ---------------------------------------------------------------------------


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists, tuples, dataclasses and
    torch optimizers (their per-parameter state, in parameter order), in
    an order that is the same on every rank that built the tree alike."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, torch.optim.Optimizer):
        return [v for group in tree.param_groups for p in group["params"]
                for _, v in sorted(tree.state.get(p, {}).items())
                if torch.is_tensor(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in _leaves(getattr(tree, f.name))]
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict().values())
    return []


def _counters(tree) -> List[tuple]:
    """(object, attribute) of each integer counter of a train state (its
    step and its optimizers' update counts), which a broadcast must carry
    as well."""
    if isinstance(tree, torch.optim.Optimizer):
        return [(tree, "count")]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = []
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            out += [(tree, f.name)] if isinstance(v, int) else _counters(v)
        return out
    return []


@torch.no_grad()
def replicate(tree, mesh: Optional[DataMesh]):
    """Broadcast every tensor of `tree` (and a train state's step and
    optimizer counts) from rank 0 in place, as one byte bucket, and return
    `tree`. Every rank must have built the same structure."""
    if mesh is None or mesh.group is None or mesh.world == 1:
        return tree
    leaves = _leaves(tree)
    slots = _counters(tree)
    counts = torch.tensor([int(getattr(o, a)) for o, a in slots],
                          dtype=torch.int64, device=mesh.device)
    parts, spans = [], []
    for t in leaves + [counts]:
        b = t.detach().contiguous().view(-1).view(torch.uint8)
        spans.append(b.numel())
        # each part padded to 8 bytes, so that every part starts aligned
        parts += [b.to(mesh.device),
                  torch.zeros(-b.numel() % 8, dtype=torch.uint8,
                              device=mesh.device)]
    bucket = torch.cat(parts)
    dist.broadcast(bucket, dist.get_global_rank(mesh.group, 0),
                   group=mesh.group)
    off = 0
    for t, n in zip(leaves + [counts], spans):
        t.copy_(bucket[off:off + n].view(t.dtype).view(t.shape))
        off += n + (-n % 8)
    for (o, a), v in zip(slots, counts.tolist()):
        setattr(o, a, v)
    return tree


_CHUNK = 1 << 22
_PRIME = 1000003


def fingerprint(tensors: Iterable[torch.Tensor], device) -> torch.Tensor:
    """Two int64 sums over the bytes of `tensors` (read as int32 words
    where they fill them): the plain sum and one weighted by position.
    Integer sums wrap and are associative, so equal tensors give equal
    fingerprints on any device and in any summation order."""
    acc = torch.zeros(2, dtype=torch.int64, device=device)
    for t in tensors:
        w = t.detach().contiguous().view(-1).view(torch.uint8)
        if w.numel() % 4 == 0 and w.storage_offset() % 4 == 0:
            w = w.view(torch.int32)
        for off in range(0, w.numel(), _CHUNK):
            x = w[off:off + _CHUNK].to(device=device, dtype=torch.int64)
            pos = torch.arange(off, off + x.numel(), device=device,
                               dtype=torch.int64) % _PRIME + 1
            acc[0] += x.sum()
            acc[1] += (x * pos).sum()
    return acc


def differing(groups: Mapping[str, object], mesh: Optional[DataMesh],
              axis: str = "data") -> List[str]:
    """The names of `groups` ({name: a tree of tensors, e.g. a module or a
    train state}) whose tensors are not the same on every rank of the
    mesh's `axis` ("data" or "model"), by one MAX all-reduce of each
    rank's fingerprints and their negatives."""
    group = None if mesh is None else {
        "data": mesh.group, "model": mesh.model_group}[axis]
    if group is None:
        return []
    names = list(groups)
    fp = torch.stack([fingerprint(_leaves(groups[n]), mesh.device)
                      for n in names])
    both = torch.cat([fp, -fp])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    hi, neg_lo = both[:len(names)], both[len(names):]
    same = (hi == -neg_lo).all(dim=1).tolist()
    return [n for n, s in zip(names, same) if not s]


def assert_replicated(groups: Mapping[str, object],
                      mesh: Optional[DataMesh], what: str = "state",
                      axis: str = "data") -> None:
    """Raise unless every rank of the mesh's `axis` holds the same tensors
    in each group."""
    bad = differing(groups, mesh, axis)
    if bad:
        raise RuntimeError(f"{what} differs across the ranks of the {axis} "
                           f"axis: {bad}")


@contextlib.contextmanager
def distributed(device=None, n_model: int = 1):
    """The mesh of an entry point: joins torchrun's process group when its
    environment names one (`init_distributed`) and leaves it on exit; a
    group that exists already (made by the caller) is used and kept;
    without either, a one-process mesh. Yields the `DataMesh` on `device`
    (this rank's card when None), with a model axis of `n_model` ranks
    (`make_mesh`; the data axis takes the rest)."""
    made = not dist.is_initialized() and "WORLD_SIZE" in os.environ
    init_distributed(device=device)
    try:
        yield make_mesh(n_model=n_model, device=device)
    finally:
        if made:
            dist.destroy_process_group()
