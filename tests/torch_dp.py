"""Two gloo ranks on the CPU for the port's data- and model-parallel tests,
and the work each rank runs (kept apart from the test modules so that a
rank imports only torch and the port).

`Ranks(world, tmp_path)` spawns `world` processes once, each joined to a
gloo group through a `file://` rendezvous under `tmp_path` (no TCP port,
so pytest-xdist workers cannot collide) and holding one intra-op thread.
`submit(fn, *args)` hands `fn(mesh, *args)` to every rank; `collect()`
returns each rank's result in rank order, or raises with the traceback of
a rank that failed. Every `fn` here is a module-level function, so that it
pickles by reference.
"""

from __future__ import annotations

import builtins
import contextlib
import os
import queue
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp


def _serve(rank, world, init_file, tasks, results):
    import torch.distributed as dist
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    torch.set_num_threads(1)
    mesh_mod.init_distributed("file://" + init_file, world, rank,
                              device="cpu")
    mesh = mesh_mod.make_mesh(device="cpu")
    while True:
        item = tasks.get()
        if item is None:
            break
        fn, args = item
        try:
            results.put((rank, True, fn(mesh, *args)))
        except Exception:
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class Ranks:
    def __init__(self, world: int, tmp_path):
        ctx = mp.get_context("spawn")
        self.world = world
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(world)]
        init = os.path.join(str(tmp_path), "rendezvous")
        self.procs = [ctx.Process(target=_serve, args=(
            r, world, init, self.tasks[r], self.results), daemon=True)
            for r in range(world)]
        for p in self.procs:
            p.start()

    def submit(self, fn, *args):
        for q in self.tasks:
            q.put((fn, args))

    def collect(self, timeout: float = 900.0):
        out = [None] * self.world
        for _ in range(self.world):
            try:
                rank, ok, res = self.results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"a rank gave no result in {timeout}s")
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{res}")
            out[rank] = res
        return out

    def run(self, fn, *args):
        self.submit(fn, *args)
        return self.collect()

    def close(self):
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()


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


def given_step(mesh, models, cfgs, meta, init, batch, noise):
    """The paired step with `mesh` on the given models, a state made from
    `init` (trainables, heads, spectral-norm vectors; constant lr 5e-4,
    broadcast from rank 0), row and noise, in fp32; returns its metrics,
    pass-1 gradients and the state's trainables, heads and spectral-norm
    vectors after it."""
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    from img2img_turbo_tpu_torch.training import losses, optim, paired
    sched = optim.make_lr_schedule("constant", LR, 0, 100)
    state = paired.make_state({k: v.clone().requires_grad_(True)
                               for k, v in init[0].items()}, init[1],
                              init[2], sched, sched)
    mesh_mod.replicate(state, mesh)
    step = paired.make_paired_train_step(
        models, cfgs, losses.PairedLossConfig(), meta, kernels=True,
        remat=False, dtype=torch.float32, mesh=mesh)
    m, grads = step(state, batch, noise, keep_grads=True)
    return {"metrics": _metrics(m), "grads": arrays(grads),
            "gen": arrays(state.gen), "disc": arrays(state.disc),
            "disc_sn": arrays(state.disc_sn)}


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
