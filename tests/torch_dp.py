"""Two gloo ranks on the CPU for the port's data- and model-parallel tests,
and the work each rank runs (kept apart from the test modules so that a
rank imports only torch and the port).

`Ranks(world, tmp_path)` spawns `world` processes once, each joined to a
gloo group through a `file://` rendezvous under `tmp_path` (no TCP port,
so pytest-xdist workers cannot collide), holding one intra-op thread and
running at the lowest scheduling priority from its start (its imports
included). `shared(world)` is the one pool of a test process: the test
modules that run in it (pytest-xdist hands each worker whole files) share
its ranks, spawned on first use and closed at exit.
`submit(fn, *args)` hands `fn(mesh, *args)` to every rank, its arguments
pickled at once, and returns the job's ticket; `collect(ticket)` returns
each rank's result of that job (by default the last one submitted) in
rank order, or raises with the traceback of a rank that failed. A test
module can so start the ranks' work early (before a long JAX compile)
and collect it later. Every `fn` here is a module-level function, so that it
pickles by reference.
"""

from __future__ import annotations

import atexit
import builtins
import contextlib
import os
import pickle
import queue
import shutil
import tempfile
import traceback
from multiprocessing.reduction import ForkingPickler

import numpy as np
import torch
import torch.multiprocessing as mp


def _serve(rank, world, init_file, tasks, results, parent):
    import torch.distributed as dist
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    torch.set_num_threads(1)
    mesh_mod.init_distributed("file://" + init_file, world, rank,
                              device="cpu")
    mesh = mesh_mod.make_mesh(device="cpu")
    while True:
        try:
            item = tasks.get(timeout=5)
        except queue.Empty:
            if os.getppid() != parent:      # the test process is gone
                break
            continue
        if item is None:
            break
        ticket, payload = item
        try:
            fn, args = pickle.loads(payload)
            results.put((ticket, rank, True, fn(mesh, *args)))
        except Exception:
            results.put((ticket, rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class Ranks:
    def __init__(self, world: int, tmp_path):
        ctx = mp.get_context("spawn")
        self.world = world
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.tickets = 0
        self.early = {}         # {ticket: {rank: (ok, result)}} not collected
        init = os.path.join(str(tmp_path), "rendezvous")
        self.procs = [ctx.Process(target=_serve, args=(
            r, world, init, self.tasks[r], self.results, os.getpid()),
            daemon=True)
            for r in range(world)]
        for p in self.procs:
            p.start()
            # the ranks yield the cores to the test workers running beside
            # them (the suite runs several at once), from before their
            # imports of torch and the port
            os.setpriority(os.PRIO_PROCESS, p.pid, 19)

    def submit(self, fn, *args) -> int:
        # pickled here, not later by the queue's feeder thread, so the
        # ranks get the arguments as they are at the call (a tensor's
        # storage is shared with the ranks, not copied: while they run,
        # change none in place)
        self.tickets += 1
        for q in self.tasks:
            q.put((self.tickets, bytes(ForkingPickler.dumps((fn, args)))))
        return self.tickets

    def collect(self, ticket=None, timeout: float = 900.0):
        ticket = self.tickets if ticket is None else ticket
        got = self.early.pop(ticket, {})
        while len(got) < self.world:
            try:
                t, rank, ok, res = self.results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"a rank gave no result in {timeout}s")
            (got if t == ticket else self.early.setdefault(t, {}))[rank] = (
                ok, res)
        for rank, (ok, res) in sorted(got.items()):
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{res}")
        return [got[r][1] for r in range(self.world)]

    def run(self, fn, *args):
        return self.collect(self.submit(fn, *args))

    def close(self):
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()


_SHARED = {}


def shared(world: int) -> Ranks:
    """This process's pool of `world` ranks, spawned on first use (its
    rendezvous in a temporary directory) and closed at exit."""
    if world not in _SHARED:
        root = tempfile.mkdtemp(prefix="ranks")
        _SHARED[world] = ranks = Ranks(world, root)
        atexit.register(shutil.rmtree, root, True)
        atexit.register(ranks.close)
    return _SHARED[world]


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------


def arrays(tensors):
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


def state_arrays(state):
    """Every tensor of a train state by name (trainables, heads,
    spectral-norm vectors, both AdamW moments) as numpy."""
    out = {}
    for part in ("gen", "disc", "disc_sn"):
        out.update({f"{part}.{k}": v for k, v in getattr(state, part).items()})
    for part, opt in (("gen", state.gen_opt), ("disc", state.disc_opt)):
        for k, p in getattr(state, part).items():
            for m, v in opt.state.get(p, {}).items():
                if torch.is_tensor(v):
                    out[f"{part}_opt.{m}.{k}"] = v
    return arrays(out) | {"step": np.asarray(state.step)}


def collectives(mesh):
    """gather_batch of rank-distinct rows in three dtypes, pmean of a
    dict, replicate of a rank-distinct state, `differing` before and
    after."""
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    r = mesh.rank
    rows = {"f32": torch.randn(2, 3, generator=torch.Generator()
                               .manual_seed(r)),
            "bf16": (torch.arange(6.0).reshape(2, 3) + 0.5 + 10 * r).to(
                torch.bfloat16),
            "u8": torch.full((2, 2, 3), 7 * r + 1, dtype=torch.uint8)}
    out = {"rows": {k: v.float().numpy() for k, v in rows.items()},
           "gathered": {k: mesh_mod.gather_batch(v, mesh).float().numpy()
                        for k, v in rows.items()}}
    mesh.reset_stats()      # this process's earlier jobs counted theirs
    mesh.timed = True
    mean = mesh_mod.pmean({"a": torch.tensor(1.0 + r),
                           "b": torch.full((2, 2), float(r)),
                           "c": torch.full((3,), 2.0 * r).to(torch.bfloat16)},
                          mesh)
    out["pmean"] = {k: (v.float().numpy(), str(v.dtype))
                    for k, v in mean.items()}
    out["pmean_stats"] = dict(mesh.stats)
    mesh.timed = False
    mesh.reset_stats()
    st = {"w": torch.randn(5, generator=torch.Generator().manual_seed(r)),
          "h": torch.full((3,), r, dtype=torch.bfloat16)}
    out["differ_before"] = mesh_mod.differing({"st": st}, mesh)
    mesh_mod.replicate(st, mesh)
    out["differ_after"] = mesh_mod.differing({"st": st}, mesh)
    out["replicated"] = {k: v.float().numpy() for k, v in st.items()}
    return out


@contextlib.contextmanager
def record_writes():
    """Records the paths this process opens for writing or creates,
    replaces or removes, in the yielded list."""
    seen = []
    real = {"open": builtins.open, "makedirs": os.makedirs,
            "replace": os.replace, "remove": os.remove, "mkdir": os.mkdir}

    def opener(file, mode="r", *a, **k):
        if any(c in mode for c in "wax+"):
            seen.append(str(file))
        return real["open"](file, mode, *a, **k)

    def wrap(name):
        def f(path, *a, **k):
            seen.append(str(path))
            return real[name](path, *a, **k)
        return f
    builtins.open = opener
    os.makedirs, os.replace, os.remove, os.mkdir = (
        wrap("makedirs"), wrap("replace"), wrap("remove"), wrap("mkdir"))
    try:
        yield seen
    finally:
        builtins.open = real["open"]
        os.makedirs, os.replace, os.remove, os.mkdir = (
            real["makedirs"], real["replace"], real["remove"], real["mkdir"])


def run_cli(mesh, which: str, argv_runs):
    """Each argv of `argv_runs` through the training CLI `which`'s `main`
    in turn (the ranks already joined their group); returns (the mains'
    results, the paths this rank wrote)."""
    from img2img_turbo_tpu_torch.cli import (train_cyclegan_turbo,
                                             train_pix2pix_turbo)
    from img2img_turbo_tpu_torch.utils import config_args
    main, parse = ((train_pix2pix_turbo.main,
                    config_args.parse_args_paired_training)
                   if which == "pix2pix" else
                   (train_cyclegan_turbo.main,
                    config_args.parse_args_unpaired_training))
    out = []
    with record_writes() as seen:
        for argv in argv_runs:
            out.append(main(parse(argv), device="cpu"))
    return out, seen


RES = 32            # MICRO configs: two levels, latents RES / 2
RES_STEP = 16       # the DP step tests' images (the engine's: RES)
LR = 5e-4


def _configs():
    from img2img_turbo_tpu_torch import configs
    from img2img_turbo_tpu_torch.models import clip_vit
    from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
    return (GeneratorConfigs(configs.MICRO_UNET, configs.MICRO_VAE,
                             configs.TINY_TEXT), clip_vit.TINY_CLIP_VIT)


def _random_b(gen, seed):
    """LoRA B at init is 0, which would hide A's gradients: random B."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, v in gen.items():
            if k.endswith(".b"):
                v.copy_(torch.randn(v.shape, generator=g) * 0.05)


def _copy(state):
    import copy
    return copy.deepcopy(state)


def paired_batch(b, seed=0, res=RES_STEP):
    rng = np.random.RandomState(seed)
    return {"conditioning_pixel_values":
            torch.tensor(rng.rand(b, res, res, 3), dtype=torch.float32),
            "output_pixel_values":
            torch.tensor(rng.rand(b, res, res, 3) * 2 - 1,
                         dtype=torch.float32),
            "input_ids": torch.tensor(rng.randint(0, 999, (b, 77)))}


def unpaired_batch(b, seed=0, res=RES_STEP):
    rng = np.random.RandomState(seed)
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in {
        "pixel_values_src": rng.rand(b, res, res, 3) * 2 - 1,
        "pixel_values_tgt": rng.rand(b, res, res, 3) * 2 - 1,
        "emb_a2b": rng.randn(b, 77, 32) * 0.5,
        "emb_b2a": rng.randn(b, 77, 32) * 0.5}.items()}


def noise(b, n, seed, res=RES):
    rng = np.random.RandomState(seed)
    return tuple(torch.tensor(rng.randn(b, res // 2, res // 2, 4),
                              dtype=torch.float32) for _ in range(n))


def _build(kind, seed):
    """(step maker mesh -> step, state, batch maker, noise maker)."""
    from img2img_turbo_tpu_torch.training import (losses, optim, paired,
                                                  runner, unpaired)
    cfgs, clip_cfg = _configs()
    sched = optim.make_lr_schedule("constant", LR, 0, 100)
    if kind == "paired":
        models, state, meta = runner.build_paired_run(
            cfgs, clip_cfg, seed=seed, device="cpu", lr_schedule=sched,
            adam_kwargs={"max_grad_norm": 1.0})
        _random_b(state.gen, seed + 1)
        return (lambda mesh, k=1: paired.make_paired_train_step(
            models, cfgs, losses.PairedLossConfig(), meta, kernels=True,
            remat=False, dtype=torch.float32, accum_steps=k, mesh=mesh),
            state, paired_batch, lambda b, seed: noise(b, 2, seed, RES_STEP))
    models, state, meta = runner.build_unpaired_run(
        cfgs, clip_cfg, seed=seed, device="cpu", lr_schedule=sched,
        rank_unet=4, rank_vae=2)
    _random_b(state.gen, seed + 1)
    return (lambda mesh, k=1: unpaired.make_unpaired_train_step(
        models, cfgs, losses.UnpairedLossConfig(), meta, kernels=True,
        remat=False, dtype=torch.float32, accum_steps=k, mesh=mesh),
        state, unpaired_batch,
        lambda b, seed: noise(b, unpaired.NUM_NOISE, seed, RES_STEP))


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def step_scenarios(mesh, kind: str, scenarios):
    """The paired or unpaired step at MICRO configs, RES_STEP x RES_STEP,
    in fp32 without remat on every rank,
    built once from a seed, broadcast from rank 0, and run from a copy of
    that state for each scenario (name, tiled, rows, accum, steps):
    tiled: every rank the global batch's first `rows` rows and noise, and
    the same step without a mesh from a copy, in this process; otherwise
    rank r takes rows [r*rows, (r+1)*rows) of a global batch of W*rows and
    of its noise for `steps` steps, and rank 0 also runs the step without
    a mesh on the whole global batch. Returns {name: metrics, states
    (numpy), the one-process step's, the names that differ across
    ranks}."""
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    make, state0, batch_of, noise_of = _build(kind, seed=0)
    mesh_mod.replicate(state0, mesh)
    out = {}
    for name, tiled, rows, accum, steps in scenarios:
        state, res = _copy(state0), {"metrics": [], "states": []}
        step = make(mesh, accum)
        if tiled:
            batch, nz = batch_of(rows, 0), noise_of(rows, 1)
            one = _copy(state0)
            res["one_metrics"] = [_metrics(make(None, accum)(one, batch,
                                                             nz)[0])]
            res["one_state"] = state_arrays(one)
            res["metrics"].append(_metrics(step(state, batch, nz)[0]))
            res["states"].append(state_arrays(state))
        else:
            w = mesh.world
            for i in range(steps):
                batch = batch_of(w * rows, 10 + i)
                nz = noise_of(w * rows, 20 + i)
                m, _ = step(state, *mesh_mod.shard_batch((batch, nz), mesh))
                res["metrics"].append(_metrics(m))
                res["states"].append(state_arrays(state))
                if mesh.rank == 0 and i == 0:
                    one = _copy(state0)
                    res["one_metrics"] = [_metrics(
                        make(None, accum)(one, batch, nz)[0])]
                    res["one_state"] = state_arrays(one)
        res["ranks_differ"] = mesh_mod.differing({"state": state}, mesh)
        out[name] = res
    return out


def engine_dp(mesh):
    """edge_to_image and sketch engines at MICRO configs with a mesh, a
    global batch of 2 at RES x RES: the gathered outputs, and this rank's
    rows from the engine without a mesh given the global noise's rows."""
    from img2img_turbo_tpu_torch.models.unet import make_twin_conv_in
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    from img2img_turbo_tpu_torch.pipelines.pix2pix import Pix2PixTurbo
    from img2img_turbo_tpu_torch.serving.engine import ServingEngine
    cfgs, _ = _configs()
    pipe = Pix2PixTurbo.from_random(torch.Generator().manual_seed(3), cfgs,
                                    dtype=torch.float32)
    _random_b({f"{m}:{n}.{ab}": e[ab] for m, lo in pipe.lora.items()
               for n, e in lo["modules"].items() for ab in ("a", "b")}, 4)
    pipe.merge()
    make_twin_conv_in(pipe.base["unet"])
    rng = np.random.RandomState(5)
    imgs = torch.tensor(rng.randint(0, 256, (mesh.world, RES, RES, 3)),
                        dtype=torch.uint8)
    caption = torch.tensor(rng.randn(1, 77, 32), dtype=torch.float32)
    lat = (mesh.world, RES // 2, RES // 2, 4)
    out = {}
    for mode, kw in (("edge_to_image", {"params": pipe.params}),
                     ("sketch", {"base": pipe.base, "lora": pipe.lora})):
        eng = ServingEngine(cfgs=cfgs, mode=mode, dtype=torch.float32,
                            device="cpu", mesh=mesh, **kw)
        got = eng.run(imgs, caption, torch.Generator().manual_seed(0), r=0.4)
        g = torch.Generator().manual_seed(0)
        draws = [torch.randn(lat, generator=g) for _ in
                 range(2 if mode == "sketch" else 1)]
        eng.mesh = None
        rows = mesh_mod.shard_batch({"img": imgs, "draws": draws}, mesh)
        one = eng.run(rows["img"], caption, r=0.4, noise=rows["draws"][-1],
                      noise_map=rows["draws"][0] if mode == "sketch"
                      else None)
        out[mode] = {"gathered": got["out"].numpy(),
                     "mine": mesh_mod.shard_batch(got["out"], mesh).numpy(),
                     "one": one["out"].numpy(),
                     "img_equal": bool(torch.equal(
                         mesh_mod.shard_batch(got["img"], mesh),
                         one["img"]))}
    return out


def given_step(mesh, models, cfgs, meta, init, batch, noise,
               kind="paired", model_axis=False, adam=None):
    """The paired (or unpaired) step on the given models, a state made from
    `init` (trainables, heads, spectral-norm vectors; constant lr 5e-4,
    AdamW's `adam` keywords, broadcast from rank 0), row and noise, in
    fp32; returns its metrics, first-pass gradients and the state's
    trainables, heads and spectral-norm vectors after it. With
    `model_axis`: on the ranks' (1, W) mesh, the UNet and the VAE(s)
    sharded (`runner.shard_for_training`) and the UNet's blocks recomputed
    (remat), with every tensor of the state after the step, the names
    `differing` finds across the model ranks and the parameter count of
    the UNet and of each VAE ("numel"); else the data mesh of the spawned
    world, without remat."""
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    from img2img_turbo_tpu_torch.training import (losses, optim, paired,
                                                  runner, unpaired)
    sched = optim.make_lr_schedule("constant", LR, 0, 100)
    state = (paired if kind == "paired" else unpaired).make_state(
        {k: v.clone().requires_grad_(True) for k, v in init[0].items()},
        init[1], init[2], sched, sched, **(adam or {}))
    mesh_mod.replicate(state, mesh)
    if model_axis:
        mesh = tp_mesh(mesh)
        runner.shard_for_training(models, mesh, state)
    make, loss_cfg = ((paired.make_paired_train_step,
                       losses.PairedLossConfig()) if kind == "paired" else
                      (unpaired.make_unpaired_train_step,
                       losses.UnpairedLossConfig()))
    step = make(models, cfgs, loss_cfg, meta, kernels=True,
                remat=model_axis, dtype=torch.float32, mesh=mesh)
    m, grads = step(state, batch, noise, keep_grads=True)
    out = {"metrics": _metrics(m), "grads": arrays(grads),
           "gen": arrays(state.gen), "disc": arrays(state.disc),
           "disc_sn": arrays(state.disc_sn)}
    if model_axis:
        out.update(state=state_arrays(state),
                   differ=mesh_mod.differing({"state": state}, mesh,
                                             axis="model"),
                   numel={name: sum(p.numel() for p in m.parameters())
                          for name, m in vars(models).items()
                          if name == "unet" or name.startswith("vae")})
    return out


# ---------------------------------------------------------------------------
# the model axis
# ---------------------------------------------------------------------------

_TP_MESHES: dict = {}


def tp_mesh(mesh):
    """This rank's (1, W) mesh over the spawned world (W = its ranks), made
    once a process (`make_mesh` makes its subgroups collectively)."""
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    if mesh.world not in _TP_MESHES:
        _TP_MESHES[mesh.world] = mesh_mod.make_mesh(1, mesh.world,
                                                    device="cpu")
    return _TP_MESHES[mesh.world]


def tp_unet(mesh, cfg, usd, x, t, ctx):
    """The UNet at `cfg` with the whole state dict `usd` sharded over the
    ranks' model axis: its eps on (x, t, ctx) in fp32 on the CPU, kernel
    path and plain path, and the parameters this rank holds."""
    from img2img_turbo_tpu_torch.models.layers import prepare_kernels
    from img2img_turbo_tpu_torch.models.unet import UNet2DConditionModel
    from img2img_turbo_tpu_torch.parallel import tensor as tensor_mod
    from img2img_turbo_tpu_torch.weights import from_jax
    tp = tp_mesh(mesh)
    model = from_jax.load(UNet2DConditionModel(cfg), usd)
    prepare_kernels(tensor_mod.shard_module(model, tp,
                                            tensor_mod.head_dim(cfg)))
    x, t, ctx = (torch.as_tensor(a) for a in (x, t, ctx))
    with torch.no_grad():
        eps = {k: model(x, t, ctx, kernels=k, tp=tp).numpy()
               for k in (True, False)}
    return {"eps": eps, "numel": sum(p.numel() for p in model.parameters()),
            "sharded": sorted(n for n, m in model.named_modules()
                              if getattr(m, "tp_sharded", False))}


def tp_vae(mesh, cfg, vsd, x):
    """The VAE at `cfg` with the whole state dict `vsd` sharded over the
    ranks' model axis: the posterior mean of `x` (encode with
    sample_posterior=False) decoded with the encoder's skips through the
    skip convs, in fp32 on the CPU, on the kernel path with live weights
    (as training runs it) and on the plain path; the same of the whole VAE
    in this process ("whole"); and the parameters and modules this rank
    holds."""
    from img2img_turbo_tpu_torch.models.vae import AutoencoderKL
    from img2img_turbo_tpu_torch.parallel import tensor as tensor_mod
    from img2img_turbo_tpu_torch.weights import from_jax
    tp = tp_mesh(mesh)
    whole = from_jax.load(AutoencoderKL(cfg), vsd)
    vae = tensor_mod.shard_module(from_jax.load(AutoencoderKL(cfg), vsd), tp,
                                  tensor_mod.vae_head_dim(cfg))
    x = torch.as_tensor(x)
    out, one = {}, {}
    with torch.no_grad():
        for path, kernels in (("live", True), ("plain", False)):
            for res, model, t in ((out, vae, tp), (one, whole, None)):
                z, skips = model.encode(x, kernels=kernels,
                                        sample_posterior=False, tp=t)
                res[path] = {"z": z.numpy(), "img": model.decode(
                    z, skips, kernels=kernels, tp=t).numpy()}
    return {"out": out, "whole": one,
            "numel": sum(p.numel() for p in vae.parameters()),
            "sharded": sorted(n for n, m in vae.named_modules()
                              if getattr(m, "tp_sharded", False))}


def engine_tp(mesh):
    """`ServingEngine(mesh=(1, W))` in edge_to_image and image mode at
    MICRO configs, a batch of 2 at RES x RES, against the engine without a
    mesh on the same weights (built first, from the same seed), noise and
    images: each mode's uint8 outputs, and the UNet parameters the sharded
    engine holds against the whole UNet's."""
    from img2img_turbo_tpu_torch.serving.engine import ServingEngine
    from img2img_turbo_tpu_torch.weights import from_jax
    cfgs, _ = _configs()
    tp = tp_mesh(mesh)
    rng = np.random.RandomState(5)
    imgs = torch.tensor(rng.randint(0, 256, (2, RES, RES, 3)),
                        dtype=torch.uint8)
    caption = torch.tensor(rng.randn(1, 77, 32), dtype=torch.float32)
    out = {}
    for mode in ("edge_to_image", "image"):
        g = torch.Generator().manual_seed(7)
        params = {"unet": from_jax.random_model(cfgs.unet, g),
                  "vae": from_jax.random_model(cfgs.vae, g)}
        whole = sum(p.numel() for p in params["unet"].parameters())
        one = ServingEngine(params, cfgs, mode=mode, dtype=torch.float32,
                            device="cpu").run(
            imgs, caption, torch.Generator().manual_seed(0))
        eng = ServingEngine(params, cfgs, mode=mode, dtype=torch.float32,
                            device="cpu", mesh=tp)
        got = eng.run(imgs, caption, torch.Generator().manual_seed(0))
        out[mode] = {"one": one["out"].numpy(), "tp": got["out"].numpy(),
                     "numel": sum(p.numel() for p in eng.unet.parameters()),
                     "whole": whole}
    return out


def tp_ops(mesh):
    """Each model-axis operator on the ranks' (1, W) mesh against
    whole-tensor autograd in this process, in fp32 and bf16 (inputs drawn
    alike on every rank): {"<op> <dtype>": (forward equal, gradient
    equal)}, every comparison exact."""
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    tp = tp_mesh(mesh)
    n, r = tp.n_model, tp.model_rank
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(0)

        def rn(width=4 * n):
            return torch.randn(3, 5, width, generator=g).to(dtype)
        whole, grad_out = rn(), rn()
        parts = [rn() for _ in range(n)]        # rank r's own tensor
        k = whole.shape[-1] // n
        mine = slice(r * k, (r + 1) * k)
        name = str(dtype).split(".")[-1]

        def leaf(t):
            return t.clone().requires_grad_(True)

        # copy: the same x on every rank, each rank's loss its own part
        x = leaf(whole)
        y = mesh_mod.model_copy(x, tp)
        (gx,) = torch.autograd.grad((y * parts[r]).sum(), x)
        xw = leaf(whole)
        (gw,) = torch.autograd.grad(sum((xw * p).sum() for p in parts), xw)
        out[f"copy {name}"] = (torch.equal(y, whole), torch.equal(gx, gw))
        # reduce: each rank its partial result, the whole output's gradient
        x = leaf(parts[r])
        y = mesh_mod.model_reduce(x, tp)
        (gx,) = torch.autograd.grad((y * grad_out).sum(), x)
        xs = [leaf(p) for p in parts]
        yw = xs[0]
        for t in xs[1:]:
            yw = yw + t
        (gw,) = torch.autograd.grad((yw * grad_out).sum(), xs[r])
        out[f"reduce {name}"] = (torch.equal(y, yw), torch.equal(gx, gw))
        # gather: each rank its slice, the whole output's gradient
        x = leaf(whole[..., mine])
        y = mesh_mod.model_gather(x, tp)
        (gx,) = torch.autograd.grad((y * grad_out).sum(), x)
        xw = leaf(whole)
        (gw,) = torch.autograd.grad((xw * grad_out).sum(), xw)
        out[f"gather {name}"] = (torch.equal(y, whole),
                                 torch.equal(gx, gw[..., mine]))
        # scatter, plain and in halves: each rank's loss on its slice
        for halves in (False, True):
            x = leaf(whole)
            y = mesh_mod.model_scatter(x, tp, halves=halves)
            if halves:
                v, gt = whole.chunk(2, -1)
                kk = v.shape[-1] // n
                want = torch.cat([v[..., r * kk:(r + 1) * kk],
                                  gt[..., r * kk:(r + 1) * kk]], -1)
                go = torch.cat([t[..., r * kk:(r + 1) * kk]
                                for t in grad_out.chunk(2, -1)], -1)
            else:
                want, go = whole[..., mine], grad_out[..., mine]
            (gx,) = torch.autograd.grad((y * go).sum(), x)
            xw = leaf(whole)
            (gw,) = torch.autograd.grad((xw * grad_out).sum(), xw)
            key = f"scatter{' halves' if halves else ''} {name}"
            out[key] = (torch.equal(y, want), torch.equal(gx, gw))
    return out


@contextlib.contextmanager
def kernel_calls():
    """Counts the calls of each kernel wrapper of `ops/` that the layers
    reach (K1, K8's du, K3, K2, K7, K5 and its combine) in the yielded
    Counter, by patching the wrappers in their modules for the block."""
    import collections
    from img2img_turbo_tpu_torch.ops import (attention, fused_conv,
                                             fused_matmul, groupnorm)
    seen = collections.Counter()
    slots = [(fused_conv, "fused_gn_silu_conv3x3"),
             (fused_conv, "conv3x3_input_grad"), (fused_matmul, "fused"),
             (attention, "flash_attention_folded"),
             (attention, "flash_attention_folded_bwd"),
             (groupnorm, "group_norm_coeffs"), (groupnorm, "combine_stats")]
    real = [getattr(mod, name) for mod, name in slots]

    def counted(name, fn):
        def f(*a, **k):
            seen[name] += 1
            return fn(*a, **k)
        return f
    for (mod, name), fn in zip(slots, real):
        setattr(mod, name, counted(name, fn))
    try:
        yield seen
    finally:
        for (mod, name), fn in zip(slots, real):
            setattr(mod, name, fn)


def tp_layers(mesh, cfg):
    """A ResnetBlock2D with a 1x1 shortcut, one with a residual, and a
    Transformer2DModel at level 0 and at the deepest level of UNet config
    `cfg` (each whole, then sharded over the ranks' (1, W) mesh by
    `parallel.tensor`'s rule), on the kernel path with live fp32 weights, the norms
    frozen: the output and the gradients of the input, of the time
    embedding or the context and of every weight under an output
    gradient, against the whole module in this process. Returns {block:
    {"sharded": the module names sharded, "err": {what: max|err| /
    max|ref|}, "calls": {"whole", "tp"}: the kernel wrappers' calls of
    each (`kernel_calls`)}}; a sharded weight's gradient is held against
    its slice of the whole's."""
    import copy
    from img2img_turbo_tpu_torch.models import layers as L
    from img2img_turbo_tpu_torch.models.unet import Transformer2DModel
    from img2img_turbo_tpu_torch.parallel import tensor as tensor_mod
    from img2img_turbo_tpu_torch.training import runner
    tp = tp_mesh(mesh)
    hd = tensor_mod.head_dim(cfg)
    c0, c1 = cfg.block_out_channels[0], cfg.block_out_channels[-1]
    gn, eps, td = cfg.norm_num_groups, cfg.norm_eps, cfg.time_embed_dim
    blocks = {
        "resnet_skip": (lambda: L.ResnetBlock2D(c0, c1, gn, eps, td), c0),
        "resnet_residual": (lambda: L.ResnetBlock2D(c1, c1, gn, eps, td),
                            c1),
        "transformer_level0": (lambda: Transformer2DModel(c0, c0 // hd, cfg),
                               c0),
        "transformer_deepest": (lambda: Transformer2DModel(c1, c1 // hd,
                                                           cfg), c1)}
    g = torch.Generator().manual_seed(3)
    out = {}
    for name, (build, c) in blocks.items():
        whole = runner.random_init(build, g)
        for m in whole.modules():
            if isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm)):
                with torch.no_grad():    # norms that are not 1 and 0
                    m.weight.uniform_(0.5, 1.5, generator=g)
                    m.bias.uniform_(-0.5, 0.5, generator=g)
                m.requires_grad_(False)
        part = tensor_mod.shard_module(copy.deepcopy(whole), tp, hd)
        x = torch.randn(2, 8, 8, c, generator=g)
        cond = (torch.randn(2, td, generator=g) if name.startswith("resnet")
                else torch.randn(2, 77, cfg.cross_attention_dim,
                                 generator=g) * 0.5)
        res, calls = {}, {}
        for which, module in (("whole", whole), ("tp", part)):
            xi, ci = x.clone().requires_grad_(), cond.clone().requires_grad_()
            with kernel_calls() as seen:
                if name.startswith("resnet"):
                    y, _ = module(xi, ci, kernels=True, emit_stats=True,
                                  tp=tp if which == "tp" else None)
                else:
                    y = module(xi, ci, kernels=True,
                               tp=tp if which == "tp" else None)
                go = torch.randn(y.shape, generator=torch.Generator()
                                 .manual_seed(5))
                params = {k: p for k, p in module.named_parameters()
                          if p.requires_grad}
                grads = torch.autograd.grad((y * go).sum(),
                                            [xi, ci, *params.values()])
            calls[which] = dict(seen)
            res[which] = {"out": y, "x": grads[0], "cond": grads[1],
                          **dict(zip(params, grads[2:]))}
        specs = part.tp_specs
        err = {}
        for k, want in res["whole"].items():
            if k in specs:
                want = tensor_mod._slice(k, want, specs[k], tp.model_rank,
                                         tp.n_model)
            got = res["tp"][k]
            err[k] = float((got - want).abs().max().detach()
                           / want.abs().max())
        out[name] = {"err": err, "calls": calls, "sharded": sorted(
            n for n, m in part.named_modules()
            if getattr(m, "tp_sharded", False))}
    return out
