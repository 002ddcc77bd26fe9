"""One client, closed loop, against the port's ServingEngine.

Set-up draws the weights and the caption embedding from the seed, builds
the engine in the traffic's mode, makes a pool of distinct synthetic uint8
batches on the host and serves `warmup_requests` of them. The window then
sends request after request for `seconds`: batch i % pool of the pool as
a numpy array, the caption embedding and the request's posterior noise
(drawn on the card from its own seed) to `ServingEngine.run`; a request
ends when its uint8 output is back on the host. A reservoir drawn from
the seed keeps `check_requests` finished requests (of the traced window
too), whose outputs are compared with the plain reference once the
windows have closed and the engine is freed. A traced run serves
TRACE_WINDOW_S more under the profiler after the window, for the
per-layer metrics, so that the profiler's host cost stays out of it.
"""

from __future__ import annotations

import gc
import random
import time

import torch

from port_bench import compare, flops, inputs, system, trace
from port_bench import weights as weights_mod
from port_bench.reference import generator, sd_turbo

TRACE_WINDOW_S = 8.0


def _noise(seed, i, shape, device, dtype):
    g = weights_mod.generator(seed, f"noise.{i}", device)
    return torch.randn(shape, generator=g, device=device, dtype=dtype)


def run(spec) -> dict:
    """spec: cfg, traffic, seed, seconds, trace, device, dtype, t0 (the
    process's start on perf_counter), check_requests, control (also run
    the control on the sample). Returns the run's raw record."""
    cfg, tr, seed, dev = spec.cfg, spec.traffic, spec.seed, spec.device
    b, h, w = tr["batch"], tr["height"], tr["width"]
    lat = (b, h // 8, w // 8, cfg["vae"]["latent_channels"])
    phases = trace.Phases(spec.t0, dev)

    rec = {"compile_s": system.build_kernels() if dev.type == "cuda"
           else {}, "setup_phases": phases}
    phases.end("kernels")
    wts = weights_mod.make(cfg, seed, dev, spec.dtype)
    phases.end("weights")
    engine = system.serving_engine(cfg, wts, tr["mode"], dev, spec.dtype)
    caption = wts.caption
    del wts
    gc.collect()
    phases.end("engine")
    pool = inputs.image_pool(seed, tr["pool_batches"] * b, h, w, dev)
    pool = [pool[i * b:(i + 1) * b] for i in range(tr["pool_batches"])]
    phases.end("inputs")
    for i in range(tr["warmup_requests"]):
        engine.run(pool[i % len(pool)], caption,
                   noise=_noise(seed, -1 - i, lat, dev, spec.dtype))["out"] \
            .cpu()
    phases.end("warmup")
    rng = random.Random(weights_mod.sub_seed(seed, "sample"))
    keep = []

    def request(i):
        res = engine.run(pool[i % len(pool)], caption,
                         noise=_noise(seed, i, lat, dev, spec.dtype))
        out = res["out"].cpu().numpy()
        item = (i, res["x0"], res["img"], out)
        if len(keep) < spec.check_requests:
            keep.append(item)
        else:
            j = rng.randrange(i + 1)
            if j < spec.check_requests:
                keep[j] = item

    m = trace.measure(request, spec.seconds, dev,
                      trace_s=TRACE_WINDOW_S if spec.trace else 0.0,
                      shapes=system.launch_shapes() if spec.trace else None)
    rec.update(m, setup_s=m["t_start"] - spec.t0, failed=0,
               images=m["attempted"] * b,
               flops=flops.serve_image(cfg, h, w) * m["attempted"] * b)
    del engine
    trace.release(dev)
    rec.update(check(spec, sorted(keep, key=lambda k: k[0]), pool, lat))
    return rec


def check(spec, keep, pool, lat) -> dict:
    """Readings of the kept requests against the fp32 reference, image by
    image; with spec.control also the control's (the reference in fp8)
    against the same reference."""
    cfg, dev, mode = spec.cfg, spec.device, spec.traffic["mode"]
    t0 = time.perf_counter()
    with compare.fp32_exact():
        wts = weights_mod.make(cfg, spec.seed, dev, spec.dtype)
        p_unet = sd_turbo.merge_lora(
            wts.unet, [a for a in wts.adapters if a.model == "unet"])
        p_vae = sd_turbo.merge_lora(
            wts.vae, [a for a in wts.adapters if a.model == "vae"])
        caption = wts.caption
        del wts
        got, ctl = [], []
        with torch.no_grad():
            for i, x0, img, out in keep:
                batch = torch.from_numpy(pool[i % len(pool)]).to(dev)
                noise = _noise(spec.seed, i, lat, dev, spec.dtype)
                for r in range(batch.shape[0]):
                    args = (p_unet, p_vae, cfg, mode, batch[r:r + 1],
                            caption, noise[r:r + 1])
                    ref = generator.serve(*args)
                    got.append(compare.readings(
                        {"x0": x0[r], "img": img[r],
                         "out": torch.from_numpy(out[r]).to(dev)},
                        {k: v[0] for k, v in ref.items()}))
                    if spec.control:
                        low = generator.serve(*args, q=compare.fp8_round)
                        ctl.append(compare.readings(
                            {k: v[0] for k, v in low.items()},
                            {k: v[0] for k, v in ref.items()}))
    out = {"numbers": compare.worst(got), "checked_images": len(got),
           "check_s": time.perf_counter() - t0}
    if ctl:
        out["control_numbers"] = compare.worst(ctl)
    return out
