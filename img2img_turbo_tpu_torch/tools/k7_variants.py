"""Time variants of this checkout's K7 kernels (`csrc/attention_bwd.cu`)
on one CUDA card, to measure its design steps and the choices it makes:

    python3 img2img_turbo_tpu_torch/tools/k7_variants.py [--only base,nosplit]
    python3 img2img_turbo_tpu_torch/tools/k7_variants.py \
        --parent <checkout> --only parent,base,base,parent

Each variant is the package copied under `img2img_turbo_tpu_torch/build/
k7_variants/<name>/` (git-ignored) with `attention_bwd.cu` changed by text
substitutions that must each apply once, built with nvcc (all variants at
once, `tools/variants.py`), and run in a process of its own at
`tools/time_kernels.py`'s K7_CASES (hd 64 and hd 512) and at the hd-512
edge cases `HD512_EDGE` (the ragged S = 7350, a small ragged case at B = H
= 2, S = 16384, which walks bands); `parent` runs the same cases in another
checkout (`--parent`, built there, unpatched), so that parent, base, base,
parent compares two commits on one card:

- base: this tree;
- step1, step2, step3: the hd-64 design steps, each this tree less what
  the later steps added: (1) both kernels on wgmma fed by TMA rings, a wait
  for both S and dP before the exponentials, three stages, no split; (2)
  + the split Q walk where the dk/dv grid is under a block an SM, towards
  two blocks an SM, at least 2 Q tiles a split; (3) + the split towards
  one block an SM with at least 4 tiles, and two stages; base adds the dq
  kernel's P formed while dP runs;
- one hd-64 change against this tree each: rs_dq and rs_dkv (Q and dO, or
  K and V, as register-A fragments loaded once, so that S and dP read only
  B from shared memory), dq_serial (no overlap in the dq kernel),
  dkv_overlap (the dk/dv kernel forms P^T while dP^T runs and dS^T while
  dV runs), nosplit, split2 (towards two blocks an SM), splitmin2 (at
  least 2 Q tiles a split), st3 (three ring stages), bkv128 (the dq
  kernel streams 128-row K and V tiles), wg_dkv (the dk/dv kernel with a
  producer warpgroup at 24 registers by setmaxnreg and its consumer at
  232), wg_rs_dkv and wg_rs_overlap_dkv (that, with rs_dkv, and with
  dkv_overlap too);
- one hd-512 change against this tree each: sc_st2 (the scores kernel's
  ring at 2 stages, not 3), pr_st2 and pr_st6 (the products kernel's at 2
  or 6, not 4), band64 (bands of at most 64 MiB of P and dS, so S = 4096
  takes one band and S = 7350 four).

Prints the card's name and power limit, then one JSON object per case
(device time alone, a CUDA graph of 20 calls; max|err| / max|ref| against
`attention_bwd_ref`; the plan the variant takes; each kernel's device time
under torch.profiler; at hd 512 also SDPA's memory-efficient backward's
device time on the same inputs), then each variant's time per train step
at each head dim (each case weighted by its launches in K7_CASES).
"""

from __future__ import annotations

import json

SRC = "csrc/attention_bwd.cu"


def _rs_wgmma(n: int) -> str:
    """A register-A wgmma m64n{n}k16 with B K-major and a scale_d flag."""
    nd = n // 2
    regs = ", ".join(f"%{i}" for i in range(nd))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(nd))
    return (
        f"__device__ __forceinline__ void wgmma_m64n{n}k16_rs(float* d, const uint32_t* a, "
        "uint64_t db, int scale_d) {\n"
        f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nd + 5}, 0;\\n"\n'
        f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 {{{regs}}}, "\n'
        f'      "{{%{nd}, %{nd + 1}, %{nd + 2}, %{nd + 3}}}, %{nd + 4}, p, 1, 1, 0;\\n}}\\n"\n'
        f"      : {outs}\n"
        '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));\n}\n\n')


# Register-A fragments of a 64 x 64 tile as TMA wrote it (128-byte swizzle),
# and the register-A products at N = 64 and 128, for the rs_* variants.
RS_HELPERS = [(
    "template <int N>\n__device__ __forceinline__ void mma_ss(",
    _rs_wgmma(64) + _rs_wgmma(128) + """\
__device__ __forceinline__ void load_frag(const bf16* tile, int w, int lane,
                                          uint32_t (&fr)[4][4]) {
  const unsigned char* base = reinterpret_cast<const unsigned char*>(tile);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 16 * w + (lane >> 2) + 8 * (j & 1), c = 16 * kc + 8 * (j >> 1) + 2 * (lane & 3);
      fr[kc][j] = *reinterpret_cast<const uint32_t*>(base + r * 128 + (((c >> 3) ^ (r & 7)) << 4) +
                                                     (c & 7) * 2);
    }
}

template <int N>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a, uint64_t db, int scale_d) {
  if constexpr (N == 128)
    wgmma_m64n128k16_rs(d, a, db, scale_d);
  else
    wgmma_m64n64k16_rs(d, a, db, scale_d);
}

template <int N>
__device__ __forceinline__ void mma_ss(""")]
# The dq kernel's Q and dO as register-A fragments, loaded once.
RS_DQ = RS_HELPERS + [
    ("  i2i::mbar_wait(qbar, 0);\n",
     "  i2i::mbar_wait(qbar, 0);\n  uint32_t qf[4][4], df[4][4];\n"
     "  load_frag(Qs, warp, lane, qf);\n  load_frag(dOs, warp, lane, df);\n"),
    ("      mma_ss<BKV>(sc, i2i::smem_desc_sw128(Qs + kk * 16, 16),\n"
     "                  i2i::smem_desc_sw128(ks + kk * 16, 16), kk > 0);",
     "      mma_rs<BKV>(sc, qf[kk], i2i::smem_desc_sw128(ks + kk * 16, 16), kk > 0);"),
    ("      mma_ss<BKV>(dp, i2i::smem_desc_sw128(dOs + kk * 16, 16),\n"
     "                  i2i::smem_desc_sw128(vs + kk * 16, 16), kk > 0);",
     "      mma_rs<BKV>(dp, df[kk], i2i::smem_desc_sw128(vs + kk * 16, 16), kk > 0);")]
# The dk/dv kernel's K and V as register-A fragments, loaded once.
RS_DKV = RS_HELPERS + [
    ("  i2i::mbar_wait(kvbar, 0);\n",
     "  i2i::mbar_wait(kvbar, 0);\n  uint32_t kf[4][4], vf[4][4];\n"
     "  load_frag(Ks, warp, lane, kf);\n  load_frag(Vs, warp, lane, vf);\n"),
    ("      i2i::wgmma_m64n64k16_ss(st, i2i::smem_desc_sw128(Ks + kk * 16, 16),\n"
     "                              i2i::smem_desc_sw128(qs + kk * 16, 16), kk > 0);",
     "      mma_rs<64>(st, kf[kk], i2i::smem_desc_sw128(qs + kk * 16, 16), kk > 0);"),
    ("      i2i::wgmma_m64n64k16_ss(dpt, i2i::smem_desc_sw128(Vs + kk * 16, 16),\n"
     "                              i2i::smem_desc_sw128(ds + kk * 16, 16), kk > 0);",
     "      mma_rs<64>(dpt, vf[kk], i2i::smem_desc_sw128(ds + kk * 16, 16), kk > 0);")]
# The dq kernel waits for dP as well before the exponentials (no overlap).
DQ_SERIAL = [("    i2i::wgmma_wait<1>();\n    i2i::reg_fence(sc);\n    const int kv0",
              "    i2i::wgmma_wait<0>();\n    i2i::reg_fence(sc);\n"
              "    i2i::reg_fence(dp);\n    const int kv0")]
# The dk/dv kernel forms P^T while dP^T runs and dS^T while dV += P^T dO
# runs (three groups a tile).
DKV_OVERLAP = [
    ("(qs + kk * 16, 16), kk > 0);\n#pragma unroll\n    for (int kk = 0; kk < 4; ++kk)\n",
     "(qs + kk * 16, 16), kk > 0);\n    i2i::wgmma_commit();\n"
     "#pragma unroll\n    for (int kk = 0; kk < 4; ++kk)\n"),
    ("""    i2i::wgmma_commit();
    i2i::wgmma_wait<0>();
    i2i::reg_fence(st);
    i2i::reg_fence(dpt);
""", """    i2i::wgmma_commit();
    i2i::wgmma_wait<1>();
    i2i::reg_fence(st);
"""),
    ("""        const float l2 = ls[8 * j + 2 * t + e], dl = dls[8 * j + 2 * t + e];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * j + 2 * hh + e;
          const float p = exp2f(fmaf(st[x], a.scale_log2, -l2));
          st[x] = p;
          dpt[x] = p * (dpt[x] - dl);
        }
      }
    uint32_t pf[4][4], dsf[4][4];
    to_frag<64>(st, pf);
    to_frag<64>(dpt, dsf);

    // dV += P^T dO and dK += dS^T Q; dO and Q MN-major
    i2i::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      i2i::wgmma_m64n64k16_rs_tb(dv, pf[kc], i2i::smem_desc_sw128(ds + kc * 16 * HD, ROWS * 128));
""", """        const float l2 = ls[8 * j + 2 * t + e];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          st[4 * j + 2 * hh + e] = exp2f(fmaf(st[4 * j + 2 * hh + e], a.scale_log2, -l2));
      }
    uint32_t pf[4][4], dsf[4][4];
    to_frag<64>(st, pf);
    i2i::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      i2i::wgmma_m64n64k16_rs_tb(dv, pf[kc], i2i::smem_desc_sw128(ds + kc * 16 * HD, ROWS * 128));
    i2i::wgmma_commit();
    i2i::wgmma_wait<1>();
    i2i::reg_fence(dpt);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = dls[8 * j + 2 * t + e];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          dpt[4 * j + 2 * hh + e] = st[4 * j + 2 * hh + e] * (dpt[4 * j + 2 * hh + e] - dl);
      }
    to_frag<64>(dpt, dsf);
    i2i::wgmma_fence();
""")]
# The dk/dv kernel with a producer warpgroup (256 threads a block): the
# producer drops to 24 registers with setmaxnreg and the consumer rises to
# 232, two blocks an SM as before.
WG_DKV = [
    ("template <int ST, int MINB>\n__global__ void __launch_bounds__(THREADS, MINB)\ndkv_kernel(",
     "template <int ST, int MINB>\n__global__ void __launch_bounds__(256, MINB)\ndkv_kernel("),
    ("  if (warp == 4) {  // ---- producer\n    if (lane == 0) {\n"
     "      i2i::mbar_arrive_expect_tx(kvbar",
     "  if (warp >= 4) {  // ---- producer\n"
     '    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\\n" ::: "memory");\n'
     "    if (warp == 4 && lane == 0) {\n      i2i::mbar_arrive_expect_tx(kvbar"),
    ("  const int t = lane & 3;\n  float dk[32], dv[32];",
     '  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\\n" ::: "memory");\n'
     "  const int t = lane & 3;\n  float dk[32], dv[32];"),
    ("dkvk<<<p.dkv_grid, THREADS, DkvL::bytes, stream>>>",
     "dkvk<<<p.dkv_grid, 256, DkvL::bytes, stream>>>")]
NOSPLIT = [("  if (blocks < NUM_SMS) {", "  if (false) {")]
SPLIT2 = [("const int want = (NUM_SMS + blocks - 1) / blocks;",
           "const int want = (2 * NUM_SMS + blocks - 1) / blocks;")]
SPLITMIN2 = [("constexpr int SPLIT_MIN_TILES = 4;",
              "constexpr int SPLIT_MIN_TILES = 2;")]
ST3 = [("DQ_ST = 2,", "DQ_ST = 3,"), ("DKV_ST = 2,", "DKV_ST = 3,")]
# hd 512: ring depths, and smaller bands
SC_ST2 = [("constexpr int SC_ST = 3;", "constexpr int SC_ST = 2;")]
PR_ST2 = [("constexpr int PR_ST = 4;", "constexpr int PR_ST = 2;")]
PR_ST6 = [("constexpr int PR_ST = 4;", "constexpr int PR_ST = 6;")]
BAND64 = [("constexpr long long BAND_BYTES = 256LL << 20;",
           "constexpr long long BAND_BYTES = 64LL << 20;")]
VARIANTS = {
    "base": [],
    # the design steps, each the tree less what later steps added
    "step1": DQ_SERIAL + NOSPLIT + ST3,
    "step2": DQ_SERIAL + SPLIT2 + SPLITMIN2 + ST3,
    "step3": DQ_SERIAL,
    # one change against this tree each
    "rs_dq": RS_DQ,
    "rs_dkv": RS_DKV,
    "dq_serial": DQ_SERIAL,
    "dkv_overlap": DKV_OVERLAP,
    "nosplit": NOSPLIT,
    "split2": SPLIT2,
    "splitmin2": SPLITMIN2,
    "st3": ST3,
    "bkv128": [("constexpr int DQ_BKV = 64,", "constexpr int DQ_BKV = 128,")],
    "wg_dkv": WG_DKV,
    "wg_rs_dkv": WG_DKV + RS_DKV,
    "wg_rs_overlap_dkv": WG_DKV + RS_DKV + DKV_OVERLAP,
    "sc_st2": SC_ST2,
    "pr_st2": PR_ST2,
    "pr_st6": PR_ST6,
    "band64": BAND64,
}
# hd-512 cases beyond K7_CASES (timed, not weighted): (case, B, Sq, Skv, H)
HD512_EDGE = [
    ("hd=512 ragged S=7350", 1, 7350, 7350, 1),
    ("hd=512 Sq=300 Skv=333 H=2 B=2", 2, 300, 333, 2),
    ("hd=512 banded S=16384", 1, 16384, 16384, 1)]


def by_kernel(fn, calls: int = 20) -> dict:
    """Device time of each kernel a call of fn() launches, in us a call,
    under torch.profiler (its name cut to the kernel's own)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = next((k for k in ("prologue_kernel", "dkv_reduce",
                                     "scores_kernel", "products_kernel",
                                     "bwd_dkv_kernel", "bwd_dq_kernel",
                                     "dkv_kernel", "dq_kernel")
                         if k in e.key), e.key[:40])
            out[name] = out.get(name, 0.0) + e.self_device_time_total / calls
    return out


def run_cases(name: str) -> None:
    """In a variant's checkout: time each K7 case."""
    import torch
    from img2img_turbo_tpu_torch.ops import attention
    from img2img_turbo_tpu_torch.tools.time_kernels import (
        K7_CASES, _k7_inputs, device_ms, sdpa_backward)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    step = {64: 0.0, 512: 0.0}
    for case, b, sq, skv, h, hd, launches in K7_CASES + [
            (*c, 512, 0) for c in HD512_EDGE]:
        q, k, v, o, do, lse = _k7_inputs(rn, b, sq, skv, h, hd)

        def call():
            return attention.flash_attention_folded_bwd(q, k, v, o, do, lse,
                                                        h)
        ms = device_ms(call)
        plan = attention.flash_attention_bwd_plan(b, h, sq, skv, hd)
        rel = max((g.float() - r.float()).abs().max().item()
                  / r.float().abs().max().item() for g, r in zip(
                      call(), attention.attention_bwd_ref(q, k, v, o, do,
                                                          lse, h)))
        step[hd] += launches * ms
        out = {"variant": name, "case": case, "device_ms": ms,
               "rel_err": rel, "plan": plan, "kernels_us": by_kernel(call)}
        if hd == 512:
            backend, lib = sdpa_backward(q, k, v, do, h)
            out[f"sdpa_{backend}_backward_device_ms"] = device_ms(lib)
            del lib
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    for hd, ms in step.items():
        print(json.dumps({"variant": name, "case": f"per train step, hd {hd}",
                          "device_ms": ms}), flush=True)


def main():
    import variants  # beside this script, which is run as a file
    variants.main(__doc__, __file__, SRC, ["attention", "attention_bwd"],
                  VARIANTS, variants.substituted, run_cases)


if __name__ == "__main__":
    main()
