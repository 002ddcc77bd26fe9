"""Time kernels of the checkout in the current directory on one CUDA card,
so that two versions of them can be compared in one machine session:

    cd <checkout> && python3 <path>/img2img_turbo_tpu_torch/tools/time_kernels.py [--only K3,du]

The package is imported from the current directory, not from beside this
file: run it from the root of a checkout of another commit to time that
commit's kernels (in ABBA order for a comparison: parent, change, change,
parent). The kernels and their cases:

- K2 (`flash_attention_folded`, with lse) and K9 (`flash_attention`) at
  chip_smoke.py's attention shapes;
- K3 (`fused_matmul.fused`) at the transformer and VAE mid-attention shapes
  of a 512x512 request and a train step; weights are nn.Linear's (Co, C),
  or (C, Co) for a checkout from before that layout (a ValueError on the
  first tells them apart; the values do not matter for a timing);
- du (K8's input gradient, `fused_conv.conv3x3_input_grad` on the
  forward's packed weight, or `layers.conv3x3_input_grad` on the nn.Conv2d
  weight in a checkout from before it) at the train step's shapes.

Each case is timed three ways on seeded bf16 inputs:

- `ms`: one call between two CUDA events, the median of 10 after a warm-up
  (host time included, as chip_smoke.py times a kernel);
- `device_ms`: 20 calls captured in one CUDA graph and replayed between two
  events, per call, the median of 5 replays (no host work between the
  launches; null if the capture fails);
- `host_us`: the host time of one call, the mean of 50 calls issued back to
  back.

Prints the card's name and power limit, then one JSON object per case.
chip_smoke.py takes its timers from here.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import os
import subprocess
import sys
import time

# (kernel, case, B, Sq, Skv, H, hd); K9 takes (B, H, S, 64) tensors
ATTENTION_CASES = [
    ("K2", "unet self S=4096 H=5", 1, 4096, 4096, 5, 64),
    ("K2", "unet cross S=4096 Skv=77 H=5", 1, 4096, 77, 5, 64),
    ("K2", "unet self S=1024 H=10", 1, 1024, 1024, 10, 64),
    ("K2", "unet cross S=1024 Skv=77 H=10", 1, 1024, 77, 10, 64),
    ("K2", "unet self S=256 H=20", 1, 256, 256, 20, 64),
    ("K2", "unet cross S=256 Skv=77 H=20", 1, 256, 77, 20, 64),
    ("K2", "unet mid self S=64 H=20", 1, 64, 64, 20, 64),
    ("K2", "unet mid cross S=64 Skv=77 H=20", 1, 64, 77, 20, 64),
    ("K2", "vae mid hd=512 S=4096", 1, 4096, 4096, 1, 512),
    ("K2", "unet ragged self S=7350 H=5", 1, 7350, 7350, 5, 64),
    ("K2", "vae mid ragged hd=512 S=7350", 1, 7350, 7350, 1, 512),
    ("K2", "unet self S=1024 H=10 B=2", 2, 1024, 1024, 10, 64),
    ("K9", "self S=4096 H=5", 1, 4096, 4096, 5, 64),
    ("K9", "cross S=4096 Skv=77 H=5", 1, 4096, 77, 5, 64),
    ("K9", "ragged S=7350 H=5", 1, 7350, 7350, 5, 64),
    ("K9", "self S=1024 H=10", 1, 1024, 1024, 10, 64),
    ("K9", "ragged S=1089 H=2", 1, 1089, 1089, 2, 64)]


def k3_shapes(m: int, c: int):
    """K3's launch shapes (M, C, Co, outputs, LN, gate, residual) in one
    SD-Turbo transformer at M rows and C channels, proj_in to proj_out: the
    context K/V (77 x 1024) is separate (`K3_KV_SHAPES`). attn1's and
    attn2's out projections and proj_out share the residual shape."""
    return [(m, c, c, 1, False, False, False),        # proj_in
            (m, c, c, 3, True, False, False),         # LN1 + q, k, v
            (m, c, c, 1, False, False, True),         # out proj + residual
            (m, c, c, 1, True, False, False),         # LN2 + q
            (m, c, 4 * c, 1, True, True, False),      # LN3 + GEGLU
            (m, 4 * c, c, 1, False, False, True)]     # ff out + residual


# the context K/V of the cross-attention at each UNet width
K3_KV_SHAPES = [(77, 1024, c, 2, False, False, False) for c in (320, 640, 1280)]
# the VAE mid attention at the latent's rows: q, k, v, then out + residual
def k3_vae_shapes(m: int):
    return [(m, 512, 512, 3, False, False, False),
            (m, 512, 512, 1, False, False, True)]


# Every K3 shape of a 512x512 request or train step (transformer rows S at
# C = 320, 640, 1280, 1280 for 64^2, 32^2, 16^2, 8^2 latents) and of an
# 840x560 request (latent 105x70: 7350, 1855, 486, 126 rows).
K3_SHAPES = sorted(set(
    [s for m, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280),
                    (7350, 320), (1855, 640), (486, 1280), (126, 1280))
     for s in k3_shapes(m, c)]
    + K3_KV_SHAPES + k3_vae_shapes(4096) + k3_vae_shapes(7350)),
    key=lambda s: (-s[0], s))

# K8's du at the train step's shapes: (case, B, H, W, C, Co) of the forward
# conv C -> Co
DU_CASES = [
    ("du vae 512^2 128->128", 1, 512, 512, 128, 128),
    ("du vae dec conv_out 128->3", 1, 512, 512, 128, 3),
    ("du vae 256^2 256->128", 1, 256, 256, 256, 128),
    ("du vae enc conv_out 512->8", 1, 64, 64, 512, 8),
    ("du unet 64^2 320->320", 1, 64, 64, 320, 320),
    ("du unet conv_out 320->4", 1, 64, 64, 320, 4),
    ("du unet 8^2 2560->1280 split-K", 1, 8, 8, 2560, 1280)]


def k3_name(shape) -> str:
    m, c, co, n, ln, gate, res = shape
    what = ("geglu " if gate else "") + ("ln " if ln else "") \
        + ("out+res " if res else "")
    return f"{what}{m}x{c}->{co}" + (f" x{n}" if n > 1 else "")


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def one_call_ms(fn, iters: int = 10) -> float:
    """fn()'s time between two CUDA events, host time included: the median
    of `iters` calls after a warm-up."""
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
    return _median(times)


def device_ms(fn, calls: int = 20, replays: int = 5):
    """fn()'s device time alone: `calls` calls captured in one CUDA graph,
    replayed between two events, per call, the median of `replays`
    replays. None, with the reason on stderr, if the capture fails."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    try:
        # relaxed: a version may call the driver (an attribute set) inside
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            for _ in range(calls):
                fn()
    except RuntimeError as err:
        print(f"device time not measured: {err}", file=sys.stderr)
        return None
    g.replay()
    times = []
    for _ in range(replays):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / calls)
    return _median(times)


def host_us(fn, iters: int = 50) -> float:
    """The host time of one call of fn(), in us: the mean over `iters` calls
    issued back to back (the card runs them behind), then one sync."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def _k3_call(fused_matmul, rn, shape):
    """A call of this checkout's K3 at `shape` on seeded inputs."""
    import torch
    m, c, co, n, ln, gate, res = shape
    wr = 2 * co if gate else co
    x = rn(1, m, c)
    ws = tuple(rn(wr, c) for _ in range(n))
    bs = tuple(rn(wr).float() for _ in range(n))
    lnp = (rn(c).float(), rn(c).float()) if ln else None
    r = rn(1, m, co) if res else None
    try:
        fused_matmul.fused(x, ws, bs, ln=lnp, residual=r, gate=gate)
    except ValueError:  # a checkout whose K3 takes (C, Co) weights
        ws = tuple(w.t().contiguous() for w in ws)
    torch.cuda.synchronize()
    return lambda: fused_matmul.fused(x, ws, bs, ln=lnp, residual=r,
                                      gate=gate)


def _du_call(rn, b, h, w, c, co):
    """A call of this checkout's K8 du on seeded inputs."""
    from img2img_turbo_tpu_torch.models import layers
    from img2img_turbo_tpu_torch.ops import fused_conv
    gy = rn(b, h, w, co)
    wt = rn(co, c, 3, 3) / math.sqrt(9 * c)          # nn.Conv2d's layout
    new = getattr(fused_conv, "conv3x3_input_grad", None)
    if new is not None and len(inspect.signature(new).parameters) == 3:
        wp = fused_conv.pack_weights(wt.permute(2, 3, 1, 0).contiguous())
        return lambda: new(gy, wp, c)
    return lambda: layers.conv3x3_input_grad(gy, wt)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--only", default="K2,K9,K3,du",
                   help="comma-separated kernels to time (K2, K9, K3, du)")
    only = set(p.parse_args().only.split(","))
    sys.path.insert(0, os.getcwd())
    import torch
    from img2img_turbo_tpu_torch.ops import attention, fused_matmul

    if not torch.cuda.is_available():
        sys.exit("time_kernels: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    def report(kernel, case, fn):
        print(json.dumps({
            "kernel": kernel, "case": case, "ms": one_call_ms(fn),
            "device_ms": device_ms(fn), "host_us": host_us(fn)}), flush=True)

    for kernel, case, b, sq, skv, h, hd in ATTENTION_CASES:
        if kernel not in only:
            continue
        if kernel == "K2":
            q, k, v = rn(b, sq, h * hd), rn(b, skv, h * hd), rn(b, skv, h * hd)
            report(kernel, case, lambda: attention.flash_attention_folded(
                q, k, v, h, return_lse=True))
        else:
            q, k, v = rn(b, h, sq, hd), rn(b, h, skv, hd), rn(b, h, skv, hd)
            report(kernel, case, lambda: attention.flash_attention(q, k, v))
    if "K3" in only:
        for shape in K3_SHAPES:
            report("K3", k3_name(shape), _k3_call(fused_matmul, rn, shape))
    if "du" in only:
        for case, *dims in DU_CASES:
            report("du", case, _du_call(rn, *dims))


if __name__ == "__main__":
    main()
