"""Back-to-back steps of the port's paired (pix2pix-turbo) train step.

Set-up draws every weight from the seed, builds the port's training state
and step as its training CLI does, and makes a pool of distinct batches
on the card: conditioning by canny from synthetic photographs, the
photographs as targets, token ids. It warms the step up for
`warmup_steps` steps on a deep copy of the state (the trainables, heads
and optimizer moments: small), so that the state itself enters the window
unstepped. The window runs steps, each on the next batch with fresh
posterior noise and ending at a device synchronisation, for `seconds` and
at least `reference_steps` steps; of its first steps it keeps the losses,
the norms of AdamW's first moments after the first and of the
trainables' change over the first `reference_steps` (taken on the card as
each ends, read after the window). A traced run then runs TRACE_WINDOW_S
more under the profiler, for the per-layer metrics. Once the windows have
closed and the program's state is freed, the fp32 reference replays the
window's first steps from the same weights, batches and noise.
"""

from __future__ import annotations

import copy
import gc
import time

import torch

from port_bench import compare, flops, system, trace
from port_bench import weights as weights_mod
from port_bench.reference import canny as canny_ref
from port_bench.reference import paired_step
from port_bench.inputs import image_pool

TRACE_WINDOW_S = 6.0
BOS, EOS = 49406, 49407


def batch_pool(cfg, tr, seed, device):
    """`pool_batches` batches of `batch` rows under the trainer's dataset
    keys: conditioning_pixel_values (B, H, W, 3) in [0, 1],
    output_pixel_values in [-1, 1], input_ids (B, 77)."""
    b, h, w, n = tr["batch"], tr["height"], tr["width"], tr["pool_batches"]
    imgs = torch.from_numpy(image_pool(seed, n * b, h, w, device)).to(device)
    c = cfg["canny"]
    edges = torch.cat([canny_ref.canny(imgs[i:i + b], c["low"], c["high"])
                       for i in range(0, n * b, b)])
    c_t = edges[..., None].expand(-1, -1, -1, 3).contiguous()
    x_tgt = imgs.float() / 127.5 - 1.0
    g = weights_mod.generator(seed, "ids", device)
    vocab = cfg["text_encoder"]["vocab_size"]
    ids = torch.randint(1, min(vocab, BOS) - 1, (n * b, 77), generator=g,
                        device=device)
    length = torch.randint(3, 40, (n * b, 1), generator=g, device=device)
    pos = torch.arange(77, device=device)[None]
    ids = torch.where(pos == length, min(EOS, vocab - 1), ids)
    ids = torch.where(pos > length, 0, ids)
    ids[:, 0] = min(BOS, vocab - 2)
    return [{"conditioning_pixel_values": c_t[i:i + b],
             "output_pixel_values": x_tgt[i:i + b],
             "input_ids": ids[i:i + b]} for i in range(0, n * b, b)]


def step_noise(cfg, tr, seed, k, device, dtype):
    """The two generator passes' posterior noise of step k, as the trainer
    draws it: fp32 normal, cast to the activation dtype."""
    shape = (tr["batch"], tr["height"] // 8, tr["width"] // 8,
             cfg["vae"]["latent_channels"])
    return tuple(torch.randn(shape, generator=weights_mod.generator(
        seed, f"noise.{k}.{i}", device), device=device).to(dtype)
        for i in range(2))


def _flat(d):
    return {k: v.detach() for k, v in d.items()}


def run(spec) -> dict:
    cfg, tr, seed, dev = spec.cfg, spec.traffic, spec.seed, spec.device
    n_ref = tr["reference_steps"]
    phases = trace.Phases(spec.t0, dev)

    rec = {"compile_s": system.build_kernels() if dev.type == "cuda"
           else {}, "setup_phases": phases}
    phases.end("kernels")
    w = weights_mod.make_train(cfg, seed, dev)
    phases.end("weights")
    state, step = system.paired_training(cfg, w, dev, spec.dtype)
    del w
    gc.collect()
    phases.end("trainer")
    pool = batch_pool(cfg, tr, seed, dev)
    phases.end("inputs")
    spare = copy.deepcopy(state)
    for k in range(tr["warmup_steps"]):
        step(spare, pool[-1 - k % len(pool)],
             step_noise(cfg, tr, seed, -1 - k, dev, spec.dtype))
    del spare
    phases.end("warmup")
    before = {**_flat(state.gen), **_flat(state.disc)}
    before = dict(zip(before, torch._foreach_add(list(before.values()), 0)))
    early = {"losses": []}

    def one(k):
        metrics, _ = step(state, pool[k % len(pool)],
                          step_noise(cfg, tr, seed, k, dev, spec.dtype))
        if k < n_ref:
            early["losses"].append(metrics)
        if k == 0:
            mu = {**compare.first_moments(state.gen_opt, state.gen),
                  **compare.first_moments(state.disc_opt, state.disc)}
            early["mu1"] = dict(zip(mu, torch._foreach_norm(
                list(mu.values()))))
        if k == n_ref - 1:
            now = {**_flat(state.gen), **_flat(state.disc)}
            early["delta"] = dict(zip(before, torch._foreach_norm(
                torch._foreach_sub([now[n] for n in before],
                                   list(before.values())))))
        trace.sync(dev)

    m = trace.measure(one, spec.seconds, dev, min_count=n_ref,
                      trace_s=TRACE_WINDOW_S if spec.trace else 0.0,
                      shapes=system.launch_shapes() if spec.trace else None)
    b = tr["batch"]
    rec.update(m, setup_s=m["t_start"] - spec.t0, failed=0,
               images=m["attempted"] * b,
               flops=flops.paired_step(cfg, b, tr["height"], tr["width"])
               * m["attempted"])
    program = {"losses": [{k: float(v) for k, v in ms.items()}
                          for ms in early["losses"]],
               "mu1": {k: v.item() for k, v in early["mu1"].items()},
               "delta": {k: v.item() for k, v in early["delta"].items()}}
    del state, step, early, before
    trace.release(dev)
    rec.update(check(spec, pool, program))
    return rec


def reference_inputs(cfg, tr, seed, device, dtype, pool=None):
    """(weights, batches, noise) of the steps the reference replays, drawn
    again from the seed."""
    pool = pool or batch_pool(cfg, tr, seed, device)
    n = tr["reference_steps"]
    return (weights_mod.make_train(cfg, seed, device),
            [pool[k % len(pool)] for k in range(n)],
            [step_noise(cfg, tr, seed, k, device, dtype) for k in range(n)])


def check(spec, pool, program) -> dict:
    """The reference's first steps from the same weights, batches and
    noise, and the readings of the program's (and with spec.control the
    control's) against them."""
    cfg, tr, dev = spec.cfg, spec.traffic, spec.device
    t0 = time.perf_counter()
    w, batches, noises = reference_inputs(cfg, tr, spec.seed, dev,
                                          spec.dtype, pool)
    with compare.fp32_exact():
        ref = compare.train_summary(paired_step.run(w, cfg, batches, noises))
        out = {"numbers": compare.train_readings(program, ref),
               "reference": ref, "program": program}
        if spec.control:
            low = compare.train_summary(paired_step.run(
                w, cfg, batches, noises, q=compare.fp8_through))
            out["control_numbers"] = compare.train_readings(low, ref)
    out["check_s"] = time.perf_counter() - t0
    out["checked_images"] = tr["batch"] * tr["reference_steps"]
    return out
