"""Time variants of this checkout's K6 kernel (`down_kernel` in
`csrc/conv.cu`) on one CUDA card, to see what bounds it:

    python3 img2img_turbo_tpu_torch/tools/k6_variants.py [--only th8,probe]

Each variant is the package copied under `img2img_turbo_tpu_torch/build/
k6_variants/<name>/` (git-ignored) with `conv.cu` changed by text
substitutions that must each apply once, built with nvcc (all variants at
once, `tools/variants.py`), and run at `tools/time_kernels.py`'s K6_CASES
in a process of its own:

- th32, th16, th8: the form's tile forced (the split still chosen per call);
  prints each case's device time alone (a CUDA graph of 20 calls);
- probe: `clock64` read around the step loop's waits; prints, per case, the
  cycles of a block of the first channel block: its prologue (to step 0's
  barrier), its steps (the waits for the copies and the barrier, and for
  the wgmma group, apart), and its epilogues;
- probe_nohalo, probe_nowts, probe_nomem: the probe with the halo copies,
  the weight copies or both left out of the step loop (wrong results; the
  steps then cost what is left).

Prints the card's name and power limit, then one JSON object per case.
"""

from __future__ import annotations

import json
import math

SRC = "csrc/conv.cu"

FORM = "for (int th = 32; th >= 8; th /= 2) {"
HALO = "        load_halo(h_it, h_c0, (gc + 1) & 1, tap - 1);"
WEIGHTS = "      if (s + LEAD < nsteps) load_w();"
PROBE = [
    ("template <int TH>\nstruct Down {",
     "__device__ long long k6_probe[4096 * 6];\n\ntemplate <int TH>\nstruct Down {"),
    ("  const int nsteps = (items - (int)blockIdx.x + (int)gridDim.x - 1) / "
     "(int)gridDim.x * NS;\n",
     "  const int nsteps = (items - (int)blockIdx.x + (int)gridDim.x - 1) / "
     "(int)gridDim.x * NS;\n"
     "  const bool probe = tid == 0 && blockIdx.z == 0 && blockIdx.x < 4096;\n"
     "  long long pc0 = clock64(), pc1 = 0, ce = 0, cw = 0, ww = 0;\n"),
    ("      cp_async_wait<LEAD - 1>();\n      fence_proxy_async();\n"
     "      __syncthreads();\n",
     "      long long q0 = clock64();\n      cp_async_wait<LEAD - 1>();\n"
     "      fence_proxy_async();\n      __syncthreads();\n"
     "      cw += clock64() - q0;\n      if (s == 0) pc1 = clock64();\n"),
    ("      i2i::wgmma_wait<1>();\n",
     "      long long q1 = clock64();\n      i2i::wgmma_wait<1>();\n"
     "      ww += clock64() - q1;\n"),
    ("    epilogue(cur, halo + ((s - 1) / 9 & 1) * G::HALO);\n",
     "    long long q2 = clock64();\n"
     "    epilogue(cur, halo + ((s - 1) / 9 & 1) * G::HALO);\n"
     "    ce += clock64() - q2;\n"),
    ("  cp_async_wait<0>();\n}\n\n// K6's split-K second pass",
     "  cp_async_wait<0>();\n  if (probe) {\n"
     "    long long* o = k6_probe + blockIdx.x * 6;\n"
     "    o[0] = pc0; o[1] = pc1; o[2] = clock64(); o[3] = ce; o[4] = cw; "
     "o[5] = ww;\n  }\n}\n\n// K6's split-K second pass"),
    ('}  // extern "C"',
     "int k6_probe_read(void* h) {\n"
     "  return (int)cudaMemcpyFromSymbol(h, k6_probe, sizeof(k6_probe));\n}\n"
     '}  // extern "C"'),
]
VARIANTS = {
    "th32": [(FORM, "for (int th = 32; th >= 32; th /= 2) {")],
    "th16": [(FORM, "for (int th = 16; th >= 16; th /= 2) {")],
    "th8": [(FORM, "for (int th = 8; th >= 8; th /= 2) {")],
    "probe": PROBE,
    "probe_nohalo": PROBE + [(HALO, "        if (false)" + HALO[7:])],
    "probe_nowts": PROBE + [(WEIGHTS, WEIGHTS.replace("if (", "if (false && "))],
    "probe_nomem": PROBE + [(HALO, "        if (false)" + HALO[7:]),
                            (WEIGHTS, WEIGHTS.replace("if (", "if (false && "))],
}


def patched(text: str, subs) -> str:
    """`text` with each (old, new) of `subs` applied; each old must occur
    once in K6's part of the file (from `down_kernel` on; the du has lines
    like its own) or, if not there, once in the whole file."""
    cut = text.index("down_kernel(DownArgs p)")
    head, tail = text[:cut], text[cut:]
    for old, new in subs:
        if tail.count(old) == 1:
            tail = tail.replace(old, new)
        elif text.count(old) == 1:
            head = head.replace(old, new)
        else:
            raise ValueError(f"substitution does not apply once: {old!r}")
    return head + tail


def run_cases(name: str) -> None:
    """In a variant's checkout: time each K6 case, or probe it."""
    import ctypes

    import numpy as np
    import torch
    from img2img_turbo_tpu_torch.ops import fused_conv as fc
    from img2img_turbo_tpu_torch.tools.time_kernels import K6_CASES, device_ms

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    lib = fc._lib()
    lib.downsample_plan.argtypes = [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_int)]
    plan = (ctypes.c_int * 7)()
    for case, b, h, w, c, pad, stats, *_ in K6_CASES:
        x = torch.randn(b, h, w, c, generator=g, device=dev).to(torch.bfloat16)
        wt = (torch.randn(3, 3, c, c, generator=g, device=dev)
              / math.sqrt(9 * c)).to(torch.bfloat16)
        bias = torch.zeros(c, device=dev)
        wp = fc.pack_weights(wt)

        def call():
            return fc.downsample2x_conv3x3(x, wt, bias, pad, emit_stats=stats,
                                           w_packed=wp)

        lib.downsample_plan(b, h, w, c, c, pad, plan)
        form = {"tile": f"{plan[0]}x8", "splits": plan[3],
                "chunks_a_split": plan[4], "items": plan[5],
                "blocks": plan[6]}
        if not name.startswith("probe"):
            print(json.dumps({"variant": name, "case": case, **form,
                              "device_ms": device_ms(call)}), flush=True)
            continue
        lib.k6_probe_read.argtypes = [ctypes.c_void_p]
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        buf = np.zeros(4096 * 6, np.int64)
        lib.k6_probe_read(buf.ctypes.data)
        # the blocks of split 0; block x walks items x, x + nb, ...
        nb = plan[6] // plan[3]
        a = buf.reshape(4096, 6)[:min(nb, 4096)]
        items = np.array([-(-(plan[5] - x) // nb) for x in range(len(a))])
        steps = (items * plan[4] * 9).sum()
        loop = (a[:, 2] - a[:, 1] - a[:, 3]).sum()
        print(json.dumps({
            "variant": name, "case": case, **form,
            "cycles_a_block": float((a[:, 2] - a[:, 0]).mean()),
            "prologue": float((a[:, 1] - a[:, 0]).mean()),
            "a_step": float(loop / steps),
            "a_step_copies_wait_and_barrier": float(a[:, 4].sum() / steps),
            "a_step_wgmma_wait": float(a[:, 5].sum() / steps),
            "an_item_epilogue": float(a[:, 3].sum() / items.sum())}),
            flush=True)


def main():
    import variants  # beside this script, which is run as a file
    variants.main(__doc__, __file__, SRC, ["conv"], VARIANTS, patched,
                  run_cases)


if __name__ == "__main__":
    main()
