"""Time the conv engine's forward (K1, and K4 in the same kernel: the engine
of `csrc/conv.cu`) in variants of this checkout and in a parent checkout on
one CUDA card, to measure its design steps and the choices it makes:

    python3 img2img_turbo_tpu_torch/tools/k1_variants.py \\
        --parent <parent root> --only parent,base,base,parent,th16,...

Each variant is the package copied under `img2img_turbo_tpu_torch/build/
k1_variants/<name>/` (git-ignored) with `conv.cu` changed by text
substitutions that must each apply once (in the engine's part of the file
where they occur there), built with nvcc (all variants at once,
`tools/variants.py`), and run in a process of its own at
`tools/time_kernels.py`'s K1_CASES (the paths' rows) and K4_CASES, taken
from beside this script whatever the checkout; `parent` runs the same cases
in the checkout `--parent` names (its own kernels, unpatched):

- base: this tree (design step 4);
- step2, step3: the design steps, each this tree less what the later
  steps added: (2) 64-channel steps with a group in flight, the next
  chunk's halo raw by cp.async and activated in place in slices, the
  16 x 8 tile at two blocks an SM, the staged epilogue, K4's four phases
  from one 16 x 8 halo; (3) + the activation on bf16 pairs and the
  residual rows loaded ahead of the epilogue; base (4) adds the small-N
  form on the 16 x 8 tile for small grids;
- one step of the design taken back each: wait0 (no wgmma group in
  flight across a step's barrier), act_before (a slice of the next chunk's
  activation before the step's wgmmas are issued, not while they run),
  silu_exact
  (the prologue's SiLU with expf and an IEEE division), nosmalln (the
  conv_outs, Co <= 32, on the 128-channel forms), nosplit (no split over
  the chunks);
- another form for every 128-channel K1 call: th32 (the 32 x 8 tile, two
  m64 tiles a warpgroup, one block an SM), t16_1sm (the 16 x 8 tile at one
  block an SM, with the ring that frees), t16_k128 (that, in 128-channel
  steps),
  k4_8x8 (K4 on an 8 x 8 tile, 128 channels a block, warpgroups taking two
  phases each, 32-channel steps);
- tma_weights: the weight tiles by TMA bulk copies that one thread issues
  (one a 2 KB span of the packed weight), completing on an mbarrier a
  stage, with no wgmma group in flight across the spin; tma_lanes: the
  same copies issued by the lanes of one warp, one each;
- what a step costs, with wrong results: noact (no activation pass),
  noload (no weight tiles loaded after the first LEAD);
- probe: `clock64` read by a block's first thread around the parts of a
  step; prints, per case a path launches, the cycles of a block of the
  first channel block and split: its prologue (to step 0's barrier), a
  step, of which the wait at its barrier, issuing its loads, issuing its
  wgmmas, its activation slice and the wait for the wgmma group, and its
  epilogue.

Prints the card's name and power limit, then one JSON object per case
(device time alone, a CUDA graph of 20 calls, and the form the variant's
plan takes where it reports one), then each variant's K1 and K4 times per
512x512 request and per train step (each case weighted by its launches in
K1_CASES and K4_CASES).
"""

from __future__ import annotations

import json
import os
import sys

SRC = "csrc/conv.cu"

ACTIVATE = """    if constexpr (PASS) {
      if (next && tap > LEAD) activate((kk + 1) & 1, tap - 1 - LEAD);
    }
"""
WAIT = "    i2i::wgmma_wait<1>();\n"
BARRIER = ("    cp_async_wait<LEAD - 1>();\n    fence_proxy_async();\n"
           "    __syncthreads();\n")
# the weight tiles by TMA bulk copies, one a (phase, channel group) issued
# by one thread and completing on the stage's mbarrier, each step's group
# retired before the next step spins on it (ptxas serialises wgmmas around
# a spin with a group in flight): (this tree's text, the variant's)
TMA_WEIGHTS = [
    ("  static constexpr int MAIN = (2 * HALO + STAGES * STAGE) * 2;\n  // the epilogue's fp32 tile",
     "  // the halos, the ring and an mbarrier a stage\n  static constexpr int MBAR = (2 * HALO + STAGES * STAGE) * 2;\n  static constexpr int MAIN = MBAR + 8 * STAGES;\n  // the epilogue's fp32 tile"),
    ('  bf16* ring = halo + 2 * G::HALO;                // STAGES x stage\n  float* acc_s = reinterpret_cast<float*>(smem);  // epilogue: [ROWS][OUT_LDF]\n',
     "  bf16* ring = halo + 2 * G::HALO;                // STAGES x stage\n  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem + G::MBAR);  // a stage's weights landed\n  float* acc_s = reinterpret_cast<float*>(smem);  // epilogue: [ROWS][OUT_LDF]\n"),
    ('    bf16* st = ring + (i % STAGES) * G::STAGE;\n    if (i < nconv) {\n      const int kk = i / T, tap = i - kk * T, c8 = (kc0 + kk) * KCH;\n#pragma unroll',
     '    bf16* st = ring + (i % STAGES) * G::STAGE;\n    if (VEC && i < nconv) {\n      if (tid == 0) {\n        const int kk = i / T, tap = i - kk * T, c8 = (kc0 + kk) * KCH;\n        const int rows = min(BNW, p.CoP - n0);\n        uint64_t* bar = wbar + i % STAGES;\n        i2i::mbar_arrive_expect_tx(bar, G::NPH * KCH * rows * 16);\n#pragma unroll\n        for (int g = 0; g < G::NPH * KCH; ++g) {\n          const int ph = g / KCH, kc = c8 + g % KCH < C8 ? c8 + g % KCH : 0;\n          const bf16* src =\n              p.w + ((size_t)((UP ? 4 * ph + tap : tap) * C8 + kc) * p.CoP + n0) * 8;\n          i2i::bulk_load(st + g * BNW * 8, src, rows * 16, bar);\n        }\n      }\n    } else if (i < nconv) {\n      const int kk = i / T, tap = i - kk * T, c8 = (kc0 + kk) * KCH;\n#pragma unroll'),
    ("  // the first chunk's halo (in group 0) and LEAD stages; a raw halo is\n  // activated once it has landed\n  if (nconv > 0) {",
     "  if (VEC && tid == 0) {\n#pragma unroll\n    for (int s = 0; s < STAGES; ++s) i2i::mbar_init(wbar + s, 1);\n    i2i::fence_mbar_init();\n  }\n  __syncthreads();\n  // the first chunk's halo (in group 0) and LEAD stages; a raw halo is\n  // activated once it has landed\n  if (nconv > 0) {"),
    ('    cp_async_wait<LEAD - 1>();\n    fence_proxy_async();\n    __syncthreads();\n    if (i + LEAD < nsteps) load_stage(i + LEAD);',
     '    cp_async_wait<LEAD - 1>();\n    if (VEC && i < nconv) i2i::mbar_wait(wbar + i % STAGES, (i / STAGES) & 1);\n    fence_proxy_async();\n    __syncthreads();\n    if (i + LEAD < nsteps) load_stage(i + LEAD);'),
    ('    i2i::wgmma_wait<1>();\n#pragma unroll\n    for (int m = 0; m < MT; ++m) i2i::reg_fence(d[m]);\n  }\n  i2i::wgmma_wait<0>();',
     '    if constexpr (VEC)\n      i2i::wgmma_wait<0>();\n    else\n      i2i::wgmma_wait<1>();\n#pragma unroll\n    for (int m = 0; m < MT; ++m) i2i::reg_fence(d[m]);\n  }\n  i2i::wgmma_wait<0>();'),
]
T16 = "conv_form_of<SAME, 1, 128, 64, 2>(K_T16, B, H, W, C, Co, Csk)"
T16_LAUNCH = "case K_T16: return launch_conv<SAME, NORM, true, 1, 128, 64, 2>"
PROBE = [
    ("__device__ __forceinline__ float silu_fast(float v) {",
     "__device__ long long k1_probe[4096 * 9];\n\n"
     "__device__ __forceinline__ float silu_fast(float v) {"),
    ("  const int C8 = (p.C + 7) / 8, Csk8 = (p.Csk + 7) / 8;\n",
     "  const int C8 = (p.C + 7) / 8, Csk8 = (p.Csk + 7) / 8;\n"
     "  const bool probe = tid == 0 && blockIdx.z == 0 && blockIdx.y == 0 "
     "&& blockIdx.x < 4096;\n"
     "  long long pc0 = clock64(), pc1 = 0, pe = 0, cw = 0, ww = 0, cl = 0, "
     "ci = 0, ca = 0;\n"),
    (BARRIER,
     "    long long q0 = clock64();\n" + BARRIER
     + "    cw += clock64() - q0;\n    if (i == 0) pc1 = clock64();\n"
     "    long long q2 = clock64();\n"),
    ("    cp_async_commit();\n    const bf16* st = ring",
     "    cp_async_commit();\n    cl += clock64() - q2;\n"
     "    long long q3 = clock64();\n    const bf16* st = ring"),
    (ACTIVATE, "    long long q4 = clock64();\n    ci += q4 - q3;\n" + ACTIVATE
     + "    ca += clock64() - q4;\n"),
    (WAIT, "    long long q1 = clock64();\n" + WAIT
     + "    ww += clock64() - q1;\n"),
    ("  cp_async_wait<0>();\n\n  // ---- epilogue:",
     "  cp_async_wait<0>();\n  pe = clock64();\n\n  // ---- epilogue:"),
    ("      st[p.Co + n0 + tid] = t2;\n    }\n  }\n}\n",
     "      st[p.Co + n0 + tid] = t2;\n    }\n  }\n  if (probe) {\n"
     "    long long* o = k1_probe + blockIdx.x * 9;\n"
     "    o[0] = pc0; o[1] = pc1; o[2] = pe; o[3] = clock64(); o[4] = cw; "
     "o[5] = ww; o[6] = cl; o[7] = ci; o[8] = ca;\n  }\n}\n"),
    ('}  // extern "C"',
     "int k1_probe_read(void* h) {\n"
     "  return (int)cudaMemcpyFromSymbol(h, k1_probe, sizeof(k1_probe));\n}\n"
     '}  // extern "C"'),
]
# TMA_WEIGHTS with the copies issued by the lanes of warp 0, one each
TMA_LANES = [
    (a, b.replace("""      if (tid == 0) {
        const int kk = i / T, tap = i - kk * T, c8 = (kc0 + kk) * KCH;
        const int rows = min(BNW, p.CoP - n0);
        uint64_t* bar = wbar + i % STAGES;
        i2i::mbar_arrive_expect_tx(bar, G::NPH * KCH * rows * 16);
#pragma unroll
        for (int g = 0; g < G::NPH * KCH; ++g) {""", """      if (warp == 0) {
        const int kk = i / T, tap = i - kk * T, c8 = (kc0 + kk) * KCH;
        const int rows = min(BNW, p.CoP - n0);
        uint64_t* bar = wbar + i % STAGES;
        if (lane == 0) i2i::mbar_arrive_expect_tx(bar, G::NPH * KCH * rows * 16);
        __syncwarp();
        for (int g = lane; g < G::NPH * KCH; g += 32) {"""))
    for a, b in TMA_WEIGHTS]
# design step 3: the small-N form on the 32 x 8 tile at every grid size
STEP3 = [("    return f.blocks >= 4 * NUM_SMS ? f\n"
          "                                   : conv_form_of<SAME, 1, 32, 64, 2>"
          "(K_SMALLN16, B, H, W, C, Co, Csk);",
          "    return f;")]
# design step 2: step 3 with the activation by element and each residual
# row loaded where it is added
STEP2 = STEP3 + [
    ("""      __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(v.h);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(v2[e]);
        v2[e] = in ? __floats2bfloat162_rn(silu_fast(f.x * sa[2 * e] + sb[2 * e]),
                                           silu_fast(f.y * sa[2 * e + 1] + sb[2 * e + 1]))
                   : __floats2bfloat162_rn(0.f, 0.f);
      }
""", """#pragma unroll
      for (int e = 0; e < 8; ++e)
        v.h[e] = __float2bfloat16(
            in ? silu_fast(__bfloat162float(v.h[e]) * sa[e] + sb[e]) : 0.f);
"""),
    ("""  // the thread's residual rows first, all in flight at once
  constexpr int RPT = ROWS / G::RG;  // rows a thread
  Pack8 rv[RPT];
#pragma unroll
  for (int t = 0; t < RPT; ++t) {
    int ho, wo;
    rv[t] = i2i::zero8();
    if (!p.res || p.splits > 1 || !row_pix(rg + G::RG * t, ho, wo) || n >= p.Co) continue;
    const bf16* src = p.res + (((size_t)b * Ho + ho) * Wo + wo) * p.Co + n;
    if (vec_out) {
      rv[t] = *reinterpret_cast<const Pack8*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (n + e < p.Co) rv[t].h[e] = src[e];
    }
  }
""", """  constexpr int RPT = ROWS / G::RG;  // rows a thread
"""),
    ("      continue;\n    }\n    Pack8 yv;\n",
     "      continue;\n    }\n    Pack8 rv = i2i::zero8();\n    if (p.res) {\n"
     "      if (vec_out) {\n        rv = *reinterpret_cast<const Pack8*>(p.res + o);\n"
     "      } else {\n#pragma unroll\n        for (int e = 0; e < 8; ++e)\n"
     "          if (n + e < p.Co) rv.h[e] = p.res[o + e];\n      }\n    }\n"
     "    Pack8 yv;\n"),
    ("rv[t_].h[e]", "rv.h[e]"),
]
VARIANTS = {
    "base": [],
    "step2": STEP2,
    "step3": STEP3,
    "wait0": [(WAIT, WAIT.replace("wait<1>", "wait<0>"))],
    "tma_weights": TMA_WEIGHTS,
    "tma_lanes": TMA_LANES,
    "act_before": [(ACTIVATE, ""),
                   ("    cp_async_commit();\n    const bf16* st = ring",
                    ACTIVATE + "    cp_async_commit();\n    const bf16* st = ring")],
    "silu_exact": [("return __fdividef(v, 1.0f + __expf(-v));",
                    "return v / (1.0f + expf(-v));")],
    "nosmalln": [("if (Co <= 32 && Csk == 0) {", "if (false) {")],
    "nosplit": [("f.pl = split_plan(f.blocks, units, NUM_SMS * BPS, 16);",
                 "f.pl = split_plan(1L << 30, units, 1, 1);")],
    "th32": [(T16, T16.replace("1, 128, 64, 2>(K_T16", "2, 128, 64, 1>(K_T16")),
             (T16_LAUNCH, T16_LAUNCH.replace("1, 128, 64, 2>", "2, 128, 64, 1>"))],
    "t16_1sm": [(T16, T16.replace(", 2>(K_T16", ", 1>(K_T16")),
                (T16_LAUNCH, T16_LAUNCH.replace("64, 2>", "64, 1>"))],
    "t16_k128": [(T16, T16.replace("1, 128, 64, 2>(K_T16", "1, 128, 128, 1>(K_T16")),
                 (T16_LAUNCH, T16_LAUNCH.replace("1, 128, 64, 2>", "1, 128, 128, 1>"))],
    "k4_8x8": [("conv_form_of<UP2, 4, 64, 64, 1>", "conv_form_of<UP2, 2, 128, 32, 1>"),
               ("launch_conv<UP2, false, true, 4, 64, 64, 1>",
                "launch_conv<UP2, false, true, 2, 128, 32, 1>"),
               ("static constexpr int TH = UP ? 16 : 16 * MT;",
                "static constexpr int TH = UP ? 8 : 16 * MT;"),
               ('  static_assert(!UP || MT == 4, "K4: an m64 tile a phase");\n', ""),
               ("int phase(int wg, int m) { return m; }",
                "int phase(int wg, int m) { return 2 * wg + m; }"),
               ("int prow(int wg) { return 8 * wg; }", "int prow(int wg) { return 0; }")],
    "noact": [("      if (next && tap > LEAD) activate(", "      if (false) activate("),
              ("      for (int sl = 0; sl < G::SLICES; ++sl) activate(0, sl);",
               "      for (int sl = 0; sl < 0; ++sl) activate(0, sl);")],
    "noload": [("    if (i + LEAD < nsteps) load_stage(i + LEAD);",
                "    if (false) load_stage(i + LEAD);"),
               ],
    "probe": PROBE,
    "t16_1sm": [(T16, T16.replace(", 2>(K_T16", ", 1>(K_T16")),
                ("case K_T16: return launch_conv<SAME, NORM, true, 1, 128, 64, 2>",
                 "case K_T16: return launch_conv<SAME, NORM, true, 1, 128, 64, 1>")],
}


def patched(text: str, subs) -> str:
    """`text` with each (old, new) of `subs` applied; each old must occur
    once in the engine's part of the file (up to the du's kernel, whose
    step loop has lines like the engine's) or, if not there, once in the
    whole file."""
    cut = text.index("// ---- K8's du, a kernel of its own")
    head, tail = text[:cut], text[cut:]
    for old, new in subs:
        if head.count(old) == 1:
            head = head.replace(old, new)
        elif text.count(old) == 1:
            tail = tail.replace(old, new)
        else:
            raise ValueError(f"substitution does not apply once: {old!r}")
    return head + tail


def run_cases(name: str) -> None:
    """In a variant's (or the parent's) checkout: time each K1 and K4 case,
    then both per request and per train step."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import time_kernels as tk  # this tree's tables, the checkout's package
    from img2img_turbo_tpu_torch.ops import fused_conv as fc

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    plan = getattr(fc, "conv_plan", None)
    if name == "probe":
        probe(fc, tk, rn)
        return
    for kernel, table, make, width in (
            ("K1", tk.K1_CASES[:tk.K1_PATH_CASES], tk._k1_call, 10),
            ("K4", tk.K4_CASES, tk._k4_call, 7)):
        rows = []
        for case, *dims in table:
            r = {"variant": name, "kernel": kernel, "case": case,
                 "device_ms": tk.device_ms(make(rn, *dims))}
            if plan is not None:
                b, h, w, c, co = dims[:5]
                csk = dims[8] if kernel == "K1" else dims[5]
                r["form"] = plan(b, h, w, c, co, csk, kernel == "K4")
            print(json.dumps(r), flush=True)
            rows.append(r["device_ms"])
        for col, what in ((width + 1, "per 512x512 request"),
                          (width + 2, "per train step")):
            print(json.dumps({
                "variant": name, "kernel": kernel, "case": what,
                "launches": sum(c[col] for c in table),
                "device_ms": sum(c[col] * t for c, t in zip(table, rows))}),
                flush=True)


def probe(fc, tk, rn) -> None:
    """Per K1 and K4 case a path launches: the cycles of a block of the first
    channel block and split (its prologue to step 0's barrier, its steps,
    of which the waits at the steps' barriers and for the wgmma group in
    flight, and its epilogue), averaged over the first 4096 tiles."""
    import numpy as np
    import torch
    lib = fc._lib()
    lib.k1_probe_read.argtypes = [__import__("ctypes").c_void_p]
    for kernel, table, make in (
            ("K1", tk.K1_CASES[:tk.K1_PATH_CASES], tk._k1_call),
            ("K4", tk.K4_CASES, tk._k4_call)):
        for case, *dims in table:
            if not dims[-1]:
                continue
            b, h, w, c, co = dims[:5]
            csk = dims[8] if kernel == "K1" else dims[5]
            form = fc.conv_plan(b, h, w, c, co, csk, kernel == "K4")
            call = make(rn, *dims)
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            buf = np.zeros(4096 * 9, np.int64)
            lib.k1_probe_read(buf.ctypes.data)
            th, t = form["tile_rows"], 4 if kernel == "K4" else 9
            tiles = -(-h // th) * -(-w // 8)
            a = buf.reshape(4096, 9)[:min(tiles, 4096)]
            steps = (form["units_a_split"] * t if form["splits"] > 1 else
                     -(-c // form["channels_a_step"]) * t
                     + -(-csk // form["skip_channels_a_step"]))
            print(json.dumps({
                "variant": "probe", "kernel": kernel, "case": case, **form,
                "steps_a_block": steps,
                "cycles_a_block": float((a[:, 3] - a[:, 0]).mean()),
                "prologue": float((a[:, 1] - a[:, 0]).mean()),
                "a_step": float((a[:, 2] - a[:, 1]).mean() / steps),
                "a_step_copies_wait_and_barrier": float(a[:, 4].mean() / steps),
                "a_step_loads_issued": float(a[:, 6].mean() / steps),
                "a_step_wgmma_issue": float(a[:, 7].mean() / steps),
                "a_step_activation": float(a[:, 8].mean() / steps),
                "a_step_wgmma_wait": float(a[:, 5].mean() / steps),
                "epilogue": float((a[:, 3] - a[:, 2]).mean())}), flush=True)


def main():
    import variants  # beside this script, which is run as a file
    variants.main(__doc__, __file__, SRC, ["conv"], VARIANTS, patched,
                  run_cases)


if __name__ == "__main__":
    main()
