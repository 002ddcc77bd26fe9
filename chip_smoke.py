"""Chip smoke for the PyTorch port: the edge_to_image serving path on one GPU.

    python3 chip_smoke.py    # one CUDA card

Phases, each fatal on failure:
1. build every CUDA kernel of the package from `csrc/` (nvcc, sm_90a);
2. kernel phase: each kernel wrapper against its plain PyTorch version on
   the card, at the main path's shapes, in bf16, with stated tolerances.
   Errors are taken against the exact plain version (`*_ref`, fp32 with one
   rounding); times against the composition the plain engine runs
   (`*_plain`, or `mha_ref` for attention);
3. engine phase: `ServingEngine(mode="edge_to_image")` at the full
   SD-Turbo widths with seeded random weights, serving 512x512 b1 requests
   and one 840x560 request, checked for shape, range, determinism, launch
   counts and agreement with the plain path on the same weights.

Prints the card's name and power limit, a JSON line with every kernel's
error and time against its plain version, and as its last line
{"ok": true, "device": {...}}. Exits non-zero, with no result line, when
no CUDA device is present or any check fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time


def _fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        _fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 10) -> float:
    """Median CUDA-event time of fn() over `iters` runs after one warm-up."""
    import torch
    fn()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

REL_TOL = 1e-2      # kernel vs plain, bf16 output: max|err| / max|ref|
STATS_TOL = 1e-3    # folded GN (a, b): emitted stats vs stats of the same y


def _rel(a, b) -> tuple:
    a, b = a.float(), b.float()
    err = (a - b).abs().max().item()
    scale = max(b.abs().max().item(), 1e-6)
    if not math.isfinite(err):
        err = float("inf")
    return err, err / scale


def kernel_phase(dev, results: list):
    import torch
    from img2img_turbo_tpu_torch.ops import (
        _build, attention, fused_conv as fc, fused_matmul as fm,
        groupnorm as gn)

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    def oihw(w):
        """HWIO (3, 3, C, Co) or (C, Co) -> nn.Conv2d's (Co, C, kh, kw)."""
        w = w if w.ndim == 4 else w[None, None]
        return w.permute(3, 2, 0, 1).contiguous()

    def record(name, route, source, replaces, case, err, rel, tol, ms,
               plain_ms):
        ok = rel <= tol
        print(f"  {name:24s} {case:44s} max_abs={err:.3e} rel={rel:.3e} "
              f"tol={tol:.0e} kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        torch.cuda.synchronize()
        if not ok:
            _fail(f"{name} {case}: rel err {rel:.3e} > {tol:.0e}")
        results.append(dict(name=name, route=route, source=source,
                            replaces=replaces, case=case, max_abs_err=err,
                            rel_err=rel, ms=ms, plain_ms=plain_ms))

    # ---- K1 -------------------------------------------------------------
    k1 = ("fused_gn_silu_conv3x3", "cuda",
          "img2img_turbo_tpu_torch/csrc/conv.cu",
          "img2img_turbo_tpu/ops/fused_conv.py:1083")

    k1_cases = [
        # (case, B, H, W, C, Co, norm, eb, res, Csk)
        ("vae 512^2x128 gn", 1, 512, 512, 128, 128, True, False, True, 0),
        ("vae conv_in C=3", 1, 512, 512, 3, 128, False, False, False, 0),
        ("vae enc conv_out Co=8", 1, 64, 64, 512, 8, True, False, False, 0),
        ("vae dec conv_out Co=3", 1, 512, 512, 128, 3, True, False, False, 0),
        ("vae 256^2 256->128 shortcut", 1, 256, 256, 256, 128, True, False,
         False, 256),
        ("unet conv_in C=4", 1, 64, 64, 4, 320, False, False, False, 0),
        ("unet 64^2x320 gn+eb", 1, 64, 64, 320, 320, True, True, False, 0),
        ("unet C=2560 eb+res+skip", 1, 8, 8, 2560, 1280, True, True, True,
         640),
        ("unet 105x70x640 ragged", 1, 105, 70, 640, 320, True, True, False,
         960),
        ("unet conv_out Co=4", 1, 64, 64, 320, 4, True, False, False, 0),
    ]
    for case, B, H, W, C, Co, norm, has_eb, has_res, csk in k1_cases:
        x = rn(B, H, W, C)
        w = rn(3, 3, C, Co, scale=1 / math.sqrt(9 * C))
        bias = rn(Co, scale=0.1, dtype=torch.float32)
        a = b = eb = res = skx = skw = None
        if norm:
            a = 1 + 0.1 * rn(B, C, dtype=torch.float32)
            b = 0.1 * rn(B, C, dtype=torch.float32)
        if has_eb:
            eb = rn(B, Co, dtype=torch.float32)
        if has_res:
            res = rn(B, H, W, Co)
        if csk:
            skx = rn(B, H, W, csk)
            skw = rn(csk, Co, scale=1 / math.sqrt(csk))
        wp = fc.pack_weights(w)
        skwp = None if skw is None else fc.pack_weights(skw)
        y, st = fc.fused_gn_silu_conv3x3(x, w, bias, a, b, eb, res, skx, skw,
                                         emit_stats=True, w_packed=wp,
                                         skip_w_packed=skwp)
        yr, _ = fc.conv3x3_ref(x, w, bias, a, b, eb, res, skx, skw)
        err, rel = _rel(y, yr)
        one = torch.ones(Co, device=dev)
        zero = torch.zeros(Co, device=dev)
        ng = 32 if Co % 32 == 0 else 1
        ca = gn.combine_stats(st, one, zero, ng, 1e-6, H * W)
        cr = gn.combine_stats(fc.output_stats(y), one, zero, ng, 1e-6, H * W)
        serr = max(_rel(ca[0], cr[0])[1], _rel(ca[1], cr[1])[1])
        if serr > STATS_TOL:
            _fail(f"K1 {case}: stats rel err {serr:.3e} > {STATS_TOL:.0e}")
        ms = _time_ms(lambda: fc.fused_gn_silu_conv3x3(
            x, w, bias, a, b, eb, res, skx, skw, emit_stats=True,
            w_packed=wp, skip_w_packed=skwp))
        w_oihw = oihw(w)
        skw_oihw = None if skw is None else oihw(skw)
        pms = _time_ms(lambda: fc.gn_silu_conv3x3_plain(
            x, w_oihw, bias, a, b, eb, res, skx, skw_oihw))
        record(*k1, case, err, rel, REL_TOL, ms, pms)

    # ---- K4 -------------------------------------------------------------
    k4 = ("upsample2x_conv3x3", "cuda", "img2img_turbo_tpu_torch/csrc/conv.cu",
          "img2img_turbo_tpu/ops/fused_conv.py:1758")
    for case, B, H, W, C, Co, csk in [
            ("vae 64->128 C=512 skip 256", 1, 64, 64, 512, 512, 256),
            ("vae 128->256 C=512 skip 128", 1, 128, 128, 512, 512, 128),
            ("vae 256->512 C=256 skip 128", 1, 256, 256, 256, 256, 128),
            ("unet 8->16 C=1280", 1, 8, 8, 1280, 1280, 0),
            ("unet 32->64 C=640", 1, 32, 32, 640, 640, 0)]:
        x = rn(B, H, W, C)
        w = rn(3, 3, C, Co, scale=1 / math.sqrt(9 * C))
        wp = fc.pack_weights(fc.fold_upsample_weights(w))
        bias = rn(Co, scale=0.1, dtype=torch.float32)
        skx = skw = None
        if csk:
            skx = rn(B, 2 * H, 2 * W, csk)
            skw = rn(csk, Co, scale=1 / math.sqrt(csk))
        skwp = None if skw is None else fc.pack_weights(skw)
        y, st = fc.upsample2x_conv3x3(x, w, bias, skx, skw, emit_stats=True,
                                      w_packed=wp, skip_w_packed=skwp)
        yr, _ = fc.upsample2x_conv3x3_ref(x, w, bias, skx, skw)
        err, rel = _rel(y, yr)
        one, zero = torch.ones(Co, device=dev), torch.zeros(Co, device=dev)
        ca = gn.combine_stats(st, one, zero, 32, 1e-6, 4 * H * W)
        cr = gn.combine_stats(fc.output_stats(y), one, zero, 32, 1e-6,
                              4 * H * W)
        serr = max(_rel(ca[0], cr[0])[1], _rel(ca[1], cr[1])[1])
        if serr > STATS_TOL:
            _fail(f"K4 {case}: stats rel err {serr:.3e} > {STATS_TOL:.0e}")
        ms = _time_ms(lambda: fc.upsample2x_conv3x3(
            x, w, bias, skx, skw, emit_stats=True, w_packed=wp,
            skip_w_packed=skwp))
        w_oihw = oihw(w)
        skw_oihw = None if skw is None else oihw(skw)
        pms = _time_ms(lambda: fc.upsample2x_conv3x3_plain(
            x, w_oihw, bias, skx, skw_oihw))
        record(*k4, case, err, rel, REL_TOL, ms, pms)

    # ---- K5 -------------------------------------------------------------
    k5 = ("group_norm_stats", "triton",
          "img2img_turbo_tpu_torch/ops/groupnorm.py",
          "img2img_turbo_tpu/ops/groupnorm.py:81")
    for case, shape in [("unet 64^2x320", (1, 64, 64, 320)),
                        ("unet concat 8^2x2560", (1, 8, 8, 2560)),
                        ("vae 256^2x256", (1, 256, 256, 256)),
                        ("ragged 105x70x640", (1, 105, 70, 640))]:
        x = rn(*shape) * 2 + 0.5
        c = shape[-1]
        scale = 1 + 0.1 * rn(c, dtype=torch.float32)
        bias = 0.1 * rn(c, dtype=torch.float32)
        ka, kb = gn.group_norm_coeffs(x, scale, bias, 32, 1e-5)
        ra, rb = gn.combine_stats(gn.partial_stats_ref(x), scale, bias, 32,
                                  1e-5, x.numel() // (shape[0] * c))
        err_a, rel_a = _rel(ka, ra)
        err_b, rel_b = _rel(kb, rb)
        # K5 and its combine against the plain engine's two-pass (a, b)
        ms = _time_ms(lambda: gn.group_norm_coeffs(x, scale, bias, 32, 1e-5))
        pms = _time_ms(lambda: gn.group_norm_coeffs_plain(x, scale, bias, 32,
                                                          1e-5))
        record(*k5, case, max(err_a, err_b), max(rel_a, rel_b), STATS_TOL,
               ms, pms)

    # ---- K3 -------------------------------------------------------------
    k3 = ("fused_matmul", "cuda", "img2img_turbo_tpu_torch/csrc/fused_matmul.cu",
          "img2img_turbo_tpu/ops/fused_matmul.py:276")
    for case, M, C, Co, n_w, ln, gate, has_res in [
            ("geglu ln 4096x320->1280", 4096, 320, 1280, 1, True, True, False),
            ("qkv ln 4096x320 x3", 4096, 320, 320, 3, True, False, False),
            ("ff out+res 4096x1280->320", 4096, 1280, 320, 1, False, False,
             True),
            ("kv context 77x1024->640 x2", 77, 1024, 640, 2, False, False,
             False),
            ("vae mid qkv 4096x512 x3", 4096, 512, 512, 3, False, False,
             False),
            ("geglu ln 64x1280->5120", 64, 1280, 5120, 1, True, True, False)]:
        x = rn(1, M, C)
        wcols = 2 * Co if gate else Co
        ws = tuple(rn(C, wcols, scale=1 / math.sqrt(C)) for _ in range(n_w))
        bs = tuple(rn(wcols, scale=0.1, dtype=torch.float32)
                   for _ in range(n_w))
        lnp = None
        if ln:
            lnp = (1 + 0.1 * rn(C, dtype=torch.float32),
                   0.1 * rn(C, dtype=torch.float32))
        res = rn(1, M, Co) if has_res else None
        outs = fm.fused(x, ws, bs, ln=lnp, residual=res, gate=gate)
        refs = fm.fused_ref(x, ws, bs, ln=lnp, residual=res, gate=gate)
        errs = [_rel(o, r) for o, r in zip(outs, refs)]
        err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
        ms = _time_ms(lambda: fm.fused(x, ws, bs, ln=lnp, residual=res,
                                       gate=gate))
        ws_t = tuple(w.t().contiguous() for w in ws)  # nn.Linear's (Co, C)
        pms = _time_ms(lambda: fm.fused_plain(x, ws_t, bs, ln=lnp,
                                              residual=res, gate=gate))
        record(*k3, case, err, rel, REL_TOL, ms, pms)

    # ---- K2 -------------------------------------------------------------
    k2 = ("flash_attention_folded", "cuda",
          "img2img_turbo_tpu_torch/csrc/attention.cu",
          "img2img_turbo_tpu/ops/attention.py:261")
    for case, B, Sq, Skv, H, hd in [
            ("unet self S=4096 H=5", 1, 4096, 4096, 5, 64),
            ("unet cross Skv=77 H=5", 1, 4096, 77, 5, 64),
            ("unet mid self S=64 H=20", 1, 64, 64, 20, 64),
            ("ragged Sq=Skv=7350 H=5", 1, 7350, 7350, 5, 64),
            ("vae mid hd=512 H=1 S=4096", 1, 4096, 4096, 1, 512),
            ("vae mid ragged hd=512 S=7350", 1, 7350, 7350, 1, 512)]:
        q, k, v = (rn(B, s, H * hd) for s in (Sq, Skv, Skv))
        o = attention.flash_attention_folded(q, k, v, H)
        orf = attention.mha_ref(q, k, v, H)
        err, rel = _rel(o, orf)
        ms = _time_ms(lambda: attention.flash_attention_folded(q, k, v, H))
        pms = _time_ms(lambda: attention.mha_ref(q, k, v, H))
        record(*k2, case, err, rel, REL_TOL, ms, pms)

    # a CUDA tensor the kernel does not take raises; it never falls back
    x = rn(1, 8, 8, 64)
    w = rn(3, 3, 64, 64)
    bias = torch.zeros(64, device=dev)
    wp = fc.pack_weights(w)
    refused = {
        "K1 fp32 input": lambda: fc.fused_gn_silu_conv3x3(
            x.float(), w, bias, w_packed=wp),
        "K1 strided input": lambda: fc.fused_gn_silu_conv3x3(
            x.transpose(1, 2), w, bias, w_packed=wp),
        "K1 without packed weights": lambda: fc.fused_gn_silu_conv3x3(
            x, w, bias),
        "K4 unfolded weights": lambda: fc.upsample2x_conv3x3(
            x, w, bias, w_packed=wp),
        "K3 C not a multiple of 8": lambda: fm.fused(
            rn(4, 12), (rn(12, 16),), (torch.zeros(16, device=dev),)),
        "K2 head dim 32": lambda: attention.flash_attention_folded(
            rn(1, 16, 64), rn(1, 16, 64), rn(1, 16, 64), 2),
        "K5 fp16 input": lambda: gn.partial_stats(x.half()),
    }
    for what, fn in refused.items():
        try:
            fn()
        except ValueError:
            continue
        _fail(f"wrapper accepted what its kernel does not take: {what}")
    print(f"  wrappers refused all {len(refused)} unsupported CUDA inputs",
          flush=True)
    _build.reset_launch_counts()


def _per_kernel(results, launches):
    """One entry per kernel: launches in the main path's 512x512 request,
    the worst error over its cases, and its time and the plain version's
    summed over its main-path cases (listed under "cases")."""
    out = {}
    for r in results:
        e = out.setdefault(r["name"], dict(
            name=r["name"], route=r["route"], source=r["source"],
            replaces=r["replaces"], launches=launches[r["name"]],
            max_abs_err=0.0, ms=0.0, plain_ms=0.0, cases=[]))
        e["max_abs_err"] = max(e["max_abs_err"], r["max_abs_err"])
        e["ms"] += r["ms"]
        e["plain_ms"] += r["plain_ms"]
        e["cases"].append({k: r[k] for k in ("case", "max_abs_err",
                                             "rel_err", "ms", "plain_ms")})
    return list(out.values())


def main():
    import torch
    if not torch.cuda.is_available():
        _fail("no CUDA device: this smoke runs only on a GPU")
    print(_smi(), flush=True)  # the card's name and power limit
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from img2img_turbo_tpu_torch.ops import _build
    t0 = time.perf_counter()
    times = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f}s "
          + " ".join(f"{k}={v:.1f}s" for k, v in times.items()), flush=True)

    results: list = []
    print("kernel phase (bf16, kernel vs plain PyTorch version):", flush=True)
    kernel_phase(dev, results)
    torch.cuda.synchronize()

    summary: dict = {}
    engine_phase(dev, summary)
    print(json.dumps({"kernels": _per_kernel(results, summary["launches"]),
                      "engine": summary["engine"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


# Kernel launches of one edge_to_image request at the SD-Turbo topology
# (4 levels, 2 layers per block, transformers on the top 3 levels), b1:
#   K1  VAE enc 22 + dec 30 (conv_in, 2 per resnet, conv_out)
#       + UNet 46 (conv_in, 2 per resnet x 22: 8 down, 2 mid, 12 up,
#       norm_out + conv_out)
#   K2  2 per transformer x 16 + 1 per VAE mid attention x 2
#   K3  9 per transformer x 16 + 2 per VAE mid attention x 2
#   K4  3 VAE decoder upsamples + 3 UNet upsamples (latent sizes even)
#   K5  GNs with no chained stats: VAE 3 after the strided downsamples +
#       2 mid res2 GN1; UNet 7 down + 2 mid + 12 up-block concats + norm_out
EXPECTED_LAUNCHES = {"fused_gn_silu_conv3x3": 98, "flash_attention_folded": 34,
                     "fused_matmul": 148, "upsample2x_conv3x3": 6,
                     "group_norm_stats": 27}
# At 840x560 the UNet's skip sizes are odd at every level, so its three
# upsamples take upsample_nearest_to + a plain conv (unet.py:350-355).
EXPECTED_LAUNCHES_840x560 = dict(EXPECTED_LAUNCHES, upsample2x_conv3x3=3)
PATH_REL_L2_TOL = 5e-2  # kernel path vs plain path, bf16, same weights


def synth_image(h: int, w: int, seed: int):
    """Seeded uint8 (1, h, w, 3) image with real edges: filled rectangles
    and discs on a flat background, plus mild noise."""
    import numpy as np
    rng = np.random.RandomState(seed)
    img = np.empty((h, w, 3), np.float32)
    img[:] = rng.randint(0, 256, 3)
    yy, xx = np.mgrid[:h, :w]
    for _ in range(12):
        color = rng.randint(0, 256, 3)
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        r = rng.randint(h // 16, h // 4)
        if rng.rand() < 0.5:
            m = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        else:
            m = (abs(yy - cy) < r) & (abs(xx - cx) < r * 3 // 2)
        img[m] = color
    img += rng.randn(h, w, 3) * 6
    return np.clip(img, 0, 255).astype(np.uint8)[None]


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-12)).item()


def engine_phase(dev, summary):
    import torch
    from img2img_turbo_tpu_torch.ops import _build
    from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
    from img2img_turbo_tpu_torch.serving.engine import ServingEngine
    from img2img_turbo_tpu_torch.weights import from_jax

    t0 = time.perf_counter()
    cfgs = GeneratorConfigs()
    g = torch.Generator(device=dev).manual_seed(1234)
    params = {"unet": from_jax.random_model(cfgs.unet, g),
              "vae": from_jax.random_model(cfgs.vae, g)}
    caption = torch.randn(1, 77, cfgs.unet.cross_attention_dim, generator=g,
                          device=dev)
    fast = ServingEngine(params, cfgs, dtype=torch.bfloat16, device=dev)
    plain = ServingEngine(params, cfgs, dtype=torch.bfloat16, device=dev,
                          use_kernels=False)
    n_params = sum(p.numel() for m in params.values() for p in m.parameters())
    torch.cuda.synchronize()
    weights_gib = torch.cuda.memory_allocated(dev) / 2 ** 30
    print(f"engine phase: SD-Turbo widths, {n_params / 1e6:.1f}M params "
          f"(random, seed 1234), bf16, set-up "
          f"{time.perf_counter() - t0:.1f}s, weights and kernel layouts "
          f"{weights_gib:.3f} GiB on the card", flush=True)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    img512 = torch.as_tensor(synth_image(512, 512, 0), device=dev)
    fast.warmup(1, 512, 512, caption)
    plain.warmup(1, 512, 512, caption)

    # one request with the launch counters read around it
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    r = fast.run(img512, caption, gen(1))
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    print(f"  launches in one 512x512 request: {counts}", flush=True)
    if counts != EXPECTED_LAUNCHES:
        _fail(f"launch counts {counts} != expected {EXPECTED_LAUNCHES}")

    def check_out(res, h, w, what):
        out, img = res["out"], res["img"]
        if out.shape != (1, h, w, 3) or out.dtype != torch.uint8:
            _fail(f"{what}: output {tuple(out.shape)} {out.dtype}")
        if not torch.isfinite(img.float()).all():
            _fail(f"{what}: non-finite values before the uint8 cast")
        if out.float().std().item() == 0.0:
            _fail(f"{what}: constant output")

    check_out(r, 512, 512, "512x512")
    again = fast.run(img512, caption, gen(1))
    if not torch.equal(again["out"], r["out"]):
        _fail("same request with the same generator seed gave another image")

    # requests timed with CUDA events, kernel path and plain path in turns
    times = {"kernels": [], "plain": []}
    for i in range(5):
        for name, eng in (("kernels", fast), ("plain", plain)):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            eng(img512, caption, gen(100 + i))
            e.record()
            e.synchronize()
            times[name].append(s.elapsed_time(e))
    p50 = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(f"  request p50 512x512 b1 (5 requests each, CUDA events): "
          f"kernels {p50['kernels']:.2f} ms, plain {p50['plain']:.2f} ms",
          flush=True)

    # kernel path vs plain path on the same weights and the same noise
    noise = torch.randn(1, 64, 64, 4, generator=gen(7), device=dev,
                        dtype=torch.bfloat16)
    rk = fast.run(img512, caption, noise=noise)
    rp = plain.run(img512, caption, noise=noise)
    errs = {k: _rel_l2(rk[k], rp[k]) for k in ("z", "x0", "img")}
    print(f"  kernel vs plain path, rel L2: {errs} (tol "
          f"{PATH_REL_L2_TOL:.0e})", flush=True)
    if max(errs.values()) > PATH_REL_L2_TOL:
        _fail(f"kernel path disagrees with the plain path: {errs}")

    # ragged request: 840x560 (latent 105x70)
    img840 = torch.as_tensor(synth_image(560, 840, 1), device=dev)
    _build.reset_launch_counts()
    rk = fast.run(img840, caption, gen(2))
    torch.cuda.synchronize()
    counts840 = dict(_build.launch_counts)
    check_out(rk, 560, 840, "840x560")
    if counts840 != EXPECTED_LAUNCHES_840x560:
        _fail(f"840x560 launch counts {counts840} != "
              f"{EXPECTED_LAUNCHES_840x560}")
    rp = plain.run(img840, caption, gen(2))
    errs840 = {k: _rel_l2(rk[k], rp[k]) for k in ("z", "x0", "img")}
    print(f"  840x560: launches {counts840}; kernel vs plain rel L2 "
          f"{errs840}", flush=True)
    if max(errs840.values()) > PATH_REL_L2_TOL:
        _fail(f"840x560 kernel path disagrees with the plain path: {errs840}")
    summary["engine"] = {"p50_ms": p50, "weights_gib": weights_gib,
                         "rel_l2_512": errs,
                         "rel_l2_840x560": errs840, "launches_512": counts,
                         "launches_840x560": counts840}
    summary["launches"] = counts


if __name__ == "__main__":
    main()
