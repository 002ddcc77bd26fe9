// Flash attention backward on folded (B, S, H*hd) tensors: kernel K7 of the
// TPU package, for Hopper (sm_90a).
//
// Replaces img2img_turbo_tpu/ops/attention.py:390 flash_attention_folded_bwd
// (bodies _flash_bwd_dq_kernel :302 and _flash_bwd_dkv_kernel :341, delta in
// XLA at :398-400). The (Sq, Skv) probabilities never reach device memory:
// each block rebuilds its tile of P = exp(S * scale - lse) from the
// forward's saved logsumexp, and forms dP = dO V^T and dS = P * (dP - delta),
// delta = rowsum(dO * O).
//
// Two kernels, as in the JAX design, and no atomics, so a repeated step is
// bit-identical:
//   dq:  a block per (Q tile, head, batch) walks every KV tile and
//        accumulates dQ = dS K * scale;
//   dkv: a block per (KV tile, head, batch) walks the Q tiles and
//        accumulates dV = P^T dO and dK = dS^T Q * scale.
// S and dP are computed in both: 7 products of Sq x Skv x hd per head
// against the least 5. P and dS are rounded to bf16 before their products,
// as the TPU kernels round them; all sums are fp32; each output is rounded
// once. Ragged Sq and Skv are masked in the kernels (the TPU version pads).
//
// hd = 64 (the UNet's self- and cross-attention), written for Hopper after
// the forward kernel (attention.cu):
//   prologue: delta = rowsum(dO * O) from 16-byte loads, written with
//        lse * log2(e) as (B, H, Sqp) fp32 scratch (Sqp = Sq rounded up to
//        64, zero past Sq), so that a Q tile's 64 values of one head are one
//        256-byte row a TMA bulk copy reads (lse arrives as (B, Sq, H), where
//        they lie at stride H);
//   dq:  64 Q rows, one consumer warpgroup and one producer warp. Q, dO and
//        the rows' lse and delta land once; K and V tiles stream through a
//        ring of mbarrier-ordered stages by TMA (3-D tensor maps over
//        (columns, rows, batch), 128-byte swizzled, zero-filled past Skv).
//        Per tile, wgmma gives S = Q K^T, then dP = dO V^T, in registers,
//        as two groups: P (exp2f, log2(e) folded in) is formed while dP
//        runs, then dS, which is rounded to bf16 in the accumulator layout,
//        the register-A fragment; dQ += dS K runs as a register-A wgmma
//        with K MN-major. Columns past Skv get P = 0 by an explicit mask
//        (TMA's zero fill gives S = 0 there, and exp(-lse) != 0);
//   dkv: 64 KV rows with K and V resident; Q and dO tiles stream with their
//        64 lse and delta values. Per tile, wgmma gives S^T = K Q^T and
//        dP^T = V dO^T, so P^T and dS^T live in registers with KV as rows,
//        and dV += P^T dO and dK += dS^T Q run as register-A wgmmas with dO
//        and Q MN-major. Rows past Sq read lse = delta = 0 and dO = Q = 0,
//        so they add nothing;
//   split: where the dkv grid is under one block an SM (the cross-attention
//        with Skv = 77), the Q walk is split across blocks, towards one
//        block an SM and at least 4 Q tiles a split; each split writes fp32
//        partial dK and dV and `dkv_reduce` adds them in split order,
//        scales dK and rounds once.
// Outputs are staged through shared memory and stored in 16-byte rows. A
// call's launch plan (tiles, stages, split, grids) lives only here
// (flash_attention_bwd_plan reports it), and so does its scratch size
// (flash_attention_bwd_workspace_bytes).
//
// hd = 512 (the VAE mid attention, one head): wmma 16x16x16 kernels that
// keep S, dP, P and dS in shared memory between phases; each warp keeps its
// share of the dQ (or dK, dV) accumulator tiles in registers, split by
// column chunks of 16 over the block's 8 warps. The dq kernel also writes
// delta, (B, Sq, H) fp32, for the dk/dv kernel.
//
// What bounds it on the H100: the work is 5 products of Sq x Skv x hd per
// head (2.5x the forward), so the long cases are compute-bound. The hd-64
// kernels are bound by registers: each tile's products wait on the
// exponentials between them, so a block's tensor-core use depends on other
// blocks on the SM filling the gaps. The dq kernel (122 registers) runs
// three blocks an SM, the dk/dv kernel (168: two 64 x 64 fp32
// accumulators, S^T and dP^T) two. Holding K and V (or Q and dO) in
// registers to halve the products' shared-memory reads, or overlapping the
// dk/dv kernel's exponentials with its products, costs registers: ptxas
// then serialises the wgmmas or a block an SM is lost, and each measured
// slower (PERF.md, tools/k7_variants.py). The Skv = 77 cases are bound by
// their launches (three or four kernels of a few microseconds).

#include <algorithm>

#include "hopper.cuh"

using i2i::bf16;
using i2i::Pack8;

namespace {

// ---------------------------------------------------------------------------
// hd = 512: wmma kernels
// ---------------------------------------------------------------------------

using namespace nvcuda;

constexpr int NT = 256;
constexpr int NW = NT / 32;

__host__ __device__ constexpr int align128(int n) { return (n + 127) / 128 * 128; }

template <int HD, int BQ, int BKV>
struct Smem {
  static constexpr int QLD = HD + 8, SLD = BKV + 4, PLD = BKV + 8;
  static constexpr int q = 0;
  static constexpr int dout = q + align128(BQ * QLD * 2);
  static constexpr int k = dout + align128(BQ * QLD * 2);
  static constexpr int v = k + align128(BKV * QLD * 2);
  static constexpr int s = v + align128(BKV * QLD * 2);
  static constexpr int dp = s + align128(BQ * SLD * 4);
  static constexpr int p = dp + align128(BQ * SLD * 4);
  static constexpr int ds = p + align128(BQ * PLD * 2);
  static constexpr int lse = ds + align128(BQ * PLD * 2);
  static constexpr int dlt = lse + align128(BQ * 4);
  static constexpr int stage = dlt + align128(BQ * 4);  // 16x16 fp32 a warp
  static constexpr int bytes = stage + NW * 256 * 4;
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// rows [0, R) of a (R, HD) tile of the folded tensor at row r0, head column
// col0; rows at or past `limit` are zero.
template <int HD, int R>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          size_t row_base, int r0, int limit,
                                          int D, size_t col0, int tid) {
  for (int c = tid; c < R * HD / 8; c += NT) {
    const int r = c / (HD / 8), cc = (c % (HD / 8)) * 8;
    Pack8 val = i2i::zero8();
    if (r0 + r < limit)
      val = *reinterpret_cast<const Pack8*>(src + (row_base + r0 + r) * D + col0 + cc);
    *reinterpret_cast<Pack8*>(&dst[r * ld + cc]) = val;
  }
}

// S = Q K^T and dP = dO V^T, (BQ, BKV) fp32 each, one 16x16 tile per task.
template <int HD, int BQ, int BKV>
__device__ __forceinline__ void scores(const bf16* Qs, const bf16* dOs,
                                       const bf16* Ks, const bf16* Vs,
                                       float* Ss, float* dPs, int warp) {
  using L = Smem<HD, BQ, BKV>;
  constexpr int SF = (BQ / 16) * (BKV / 16);
  for (int f = warp; f < 2 * SF; f += NW) {
    const bool is_dp = f >= SF;
    const int t = is_dp ? f - SF : f;
    const int fr = t / (BKV / 16), fc = t % (BKV / 16);
    const bf16* A = is_dp ? dOs : Qs;
    const bf16* Bm = is_dp ? Vs : Ks;
    Acc acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll 4
    for (int kk = 0; kk < HD; kk += 16) {
      FragA af;
      FragBT bfr;
      wmma::load_matrix_sync(af, &A[fr * 16 * L::QLD + kk], L::QLD);
      wmma::load_matrix_sync(bfr, &Bm[fc * 16 * L::QLD + kk], L::QLD);
      wmma::mma_sync(acc, af, bfr, acc);
    }
    wmma::store_matrix_sync(&(is_dp ? dPs : Ss)[fr * 16 * L::SLD + fc * 16],
                            acc, L::SLD, wmma::mem_row_major);
  }
}

// Round a warp's accumulator tile (times `mul`) to bf16 and store the rows
// below `limit` of the (16, 16) tile at (row0, col) of the folded output.
__device__ __forceinline__ void store_tile(Acc& acc, float mul, float* stage,
                                           bf16* out, size_t row_base,
                                           int row0, int limit, int D,
                                           size_t col, int lane) {
  wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 256; i += 32) {
    const int r = i / 16, c = i % 16;
    if (row0 + r < limit)
      out[(row_base + row0 + r) * D + col + c] = __float2bfloat16(stage[i] * mul);
  }
  __syncwarp();
}

template <int HD, int BQ, int BKV>
__global__ void __launch_bounds__(NT)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ o,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta, bf16* __restrict__ dq, int Sq,
              int Skv, int D, float scale) {
  using L = Smem<HD, BQ, BKV>;
  constexpr int TPR = NT / BQ;  // threads per row for delta
  constexpr int NF = (BQ / 16) * (HD / 16) / NW;
  static_assert((BQ / 16) * (HD / 16) % NW == 0, "dQ tiles per warp");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::dout);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  float* dPs = reinterpret_cast<float*>(smem + L::dp);
  bf16* dSs = reinterpret_cast<bf16*>(smem + L::ds);
  float* lses = reinterpret_cast<float*>(smem + L::lse);
  float* dlts = reinterpret_cast<float*>(smem + L::dlt);
  float* stage = reinterpret_cast<float*>(smem + L::stage);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const size_t col0 = (size_t)h * HD, qbase = (size_t)b * Sq,
               kbase = (size_t)b * Skv;

  load_tile<HD, BQ>(Qs, L::QLD, q, qbase, q0, Sq, D, col0, tid);
  load_tile<HD, BQ>(dOs, L::QLD, dout, qbase, q0, Sq, D, col0, tid);
  {
    // delta = rowsum(dO * O) over this head's columns, fp32
    const int r = tid / TPR, sub = tid % TPR;
    float acc = 0.f;
    if (q0 + r < Sq) {
      const bf16* orow = o + (qbase + q0 + r) * D + col0;
      const bf16* drow = dout + (qbase + q0 + r) * D + col0;
      for (int c = sub; c < HD; c += TPR)
        acc += __bfloat162float(orow[c]) * __bfloat162float(drow[c]);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (sub == 0) {
      const bool in = q0 + r < Sq;
      dlts[r] = acc;
      lses[r] = in ? lse[(qbase + q0 + r) * H + h] : 0.f;
      if (in) delta[(qbase + q0 + r) * H + h] = acc;
    }
  }

  Acc accs[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(accs[j], 0.f);

  for (int kv0 = 0; kv0 < Skv; kv0 += BKV) {
    __syncthreads();  // previous block done with Ks/Vs/dSs
    load_tile<HD, BKV>(Ks, L::QLD, k, kbase, kv0, Skv, D, col0, tid);
    load_tile<HD, BKV>(Vs, L::QLD, v, kbase, kv0, Skv, D, col0, tid);
    __syncthreads();
    scores<HD, BQ, BKV>(Qs, dOs, Ks, Vs, Ss, dPs, warp);
    __syncthreads();
    for (int i = tid; i < BQ * BKV; i += NT) {
      const int r = i / BKV, c = i % BKV;
      float p = 0.f;
      if (kv0 + c < Skv) p = expf(Ss[r * L::SLD + c] * scale - lses[r]);
      dSs[r * L::PLD + c] = __float2bfloat16(p * (dPs[r * L::SLD + c] - dlts[r]));
    }
    __syncthreads();
    // dQ += dS K
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = warp + j * NW;
      const int fr = f / (HD / 16), fc = f % (HD / 16);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        FragA af;
        FragB bfr;
        wmma::load_matrix_sync(af, &dSs[fr * 16 * L::PLD + kk], L::PLD);
        wmma::load_matrix_sync(bfr, &Ks[kk * L::QLD + fc * 16], L::QLD);
        wmma::mma_sync(accs[j], af, bfr, accs[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int f = warp + j * NW;
    const int fr = f / (HD / 16), fc = f % (HD / 16);
    store_tile(accs[j], scale, stage + warp * 256, dq, qbase, q0 + fr * 16, Sq,
               D, col0 + fc * 16, lane);
  }
}

template <int HD, int BQ, int BKV>
__global__ void __launch_bounds__(NT)
bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv,
               int D, float scale) {
  using L = Smem<HD, BQ, BKV>;
  constexpr int NTILE = (BKV / 16) * (HD / 16);  // of dK, and of dV
  constexpr int NF = 2 * NTILE / NW;
  static_assert(2 * NTILE % NW == 0, "dK/dV tiles per warp");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::dout);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  float* dPs = reinterpret_cast<float*>(smem + L::dp);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p);
  bf16* dSs = reinterpret_cast<bf16*>(smem + L::ds);
  float* lses = reinterpret_cast<float*>(smem + L::lse);
  float* dlts = reinterpret_cast<float*>(smem + L::dlt);
  float* stage = reinterpret_cast<float*>(smem + L::stage);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kv0 = blockIdx.x * BKV, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const size_t col0 = (size_t)h * HD, qbase = (size_t)b * Sq,
               kbase = (size_t)b * Skv;

  load_tile<HD, BKV>(Ks, L::QLD, k, kbase, kv0, Skv, D, col0, tid);
  load_tile<HD, BKV>(Vs, L::QLD, v, kbase, kv0, Skv, D, col0, tid);

  Acc accs[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(accs[j], 0.f);

  for (int q0 = 0; q0 < Sq; q0 += BQ) {
    __syncthreads();  // previous block done with Qs/dOs/Ps/dSs
    load_tile<HD, BQ>(Qs, L::QLD, q, qbase, q0, Sq, D, col0, tid);
    load_tile<HD, BQ>(dOs, L::QLD, dout, qbase, q0, Sq, D, col0, tid);
    for (int r = tid; r < BQ; r += NT) {
      const bool in = q0 + r < Sq;
      lses[r] = in ? lse[(qbase + q0 + r) * H + h] : 0.f;
      dlts[r] = in ? delta[(qbase + q0 + r) * H + h] : 0.f;
    }
    __syncthreads();
    scores<HD, BQ, BKV>(Qs, dOs, Ks, Vs, Ss, dPs, warp);
    __syncthreads();
    for (int i = tid; i < BQ * BKV; i += NT) {
      const int r = i / BKV, c = i % BKV;
      float p = 0.f;
      if (q0 + r < Sq && kv0 + c < Skv)
        p = expf(Ss[r * L::SLD + c] * scale - lses[r]);
      Ps[r * L::PLD + c] = __float2bfloat16(p);
      dSs[r * L::PLD + c] = __float2bfloat16(p * (dPs[r * L::SLD + c] - dlts[r]));
    }
    __syncthreads();
    // tiles [0, NTILE) are dV += P^T dO, [NTILE, 2 NTILE) dK += dS^T Q
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = warp + j * NW;
      const bool is_dk = f >= NTILE;
      const int t = is_dk ? f - NTILE : f;
      const int fr = t / (HD / 16), fc = t % (HD / 16);
      const bf16* Pm = is_dk ? dSs : Ps;
      const bf16* Bm = is_dk ? Qs : dOs;
#pragma unroll
      for (int kk = 0; kk < BQ; kk += 16) {
        FragAT af;
        FragB bfr;
        wmma::load_matrix_sync(af, &Pm[kk * L::PLD + fr * 16], L::PLD);
        wmma::load_matrix_sync(bfr, &Bm[kk * L::QLD + fc * 16], L::QLD);
        wmma::mma_sync(accs[j], af, bfr, accs[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int f = warp + j * NW;
    const bool is_dk = f >= NTILE;
    const int t = is_dk ? f - NTILE : f;
    const int fr = t / (HD / 16), fc = t % (HD / 16);
    store_tile(accs[j], is_dk ? scale : 1.f, stage + warp * 256,
               is_dk ? dk : dv, kbase, kv0 + fr * 16, Skv, D, col0 + fc * 16,
               lane);
  }
}

template <int HD, int BQ1, int BKV1, int BQ2, int BKV2>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, const float* lse, float* delta, bf16* dq,
           bf16* dk, bf16* dv, int B, int Sq, int Skv, int H,
           cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)HD);
  const int D = H * HD;
  {
    using L = Smem<HD, BQ1, BKV1>;
    auto kern = bwd_dq_kernel<HD, BQ1, BKV1>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((Sq + BQ1 - 1) / BQ1, H, B);
    kern<<<grid, NT, L::bytes, stream>>>(q, k, v, o, dout, lse, delta, dq, Sq,
                                         Skv, D, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  {
    using L = Smem<HD, BQ2, BKV2>;
    auto kern = bwd_dkv_kernel<HD, BQ2, BKV2>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((Skv + BKV2 - 1) / BKV2, H, B);
    kern<<<grid, NT, L::bytes, stream>>>(q, k, v, dout, lse, delta, dk, dv, Sq,
                                         Skv, D, scale);
  }
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// hd = 64: wgmma fed by TMA
// ---------------------------------------------------------------------------

namespace h64 {

constexpr int HD = 64;
constexpr int ROWS = 64;              // rows of a TMA box, a Q tile and a KV tile
constexpr int BOX = ROWS * HD;        // elements of a box: 8 KB, 128-byte rows
constexpr int THREADS = 128 + 32;     // one consumer warpgroup, one producer warp
constexpr int NUM_SMS = 132;
constexpr int SPLIT_MIN_TILES = 4;    // Q tiles a split walks at least
constexpr float LOG2E = 1.4426950408889634f;

// dq kernel: KV rows a tile, ring stages, blocks an SM (at least; its 122
// registers give three)
constexpr int DQ_BKV = 64, DQ_ST = 2, DQ_MINB = 2;
// dk/dv kernel: ring stages, blocks an SM
constexpr int DKV_ST = 2, DKV_MINB = 2;

// Shared memory of the dq kernel: Q and dO, the K and V ring, the rows' lse
// and delta, the barriers; every tile 1024-byte aligned for the swizzle.
template <int BKV, int ST>
struct DqSmem {
  static constexpr int q = 0;
  static constexpr int dout = q + BOX * 2;
  static constexpr int k = dout + BOX * 2;
  static constexpr int v = k + ST * BKV * HD * 2;
  static constexpr int lse = v + ST * BKV * HD * 2;
  static constexpr int dlt = lse + ROWS * 4;
  static constexpr int bars = dlt + ROWS * 4;  // qbar, full[ST], empty[ST]
  static constexpr int bytes = bars + 8 * (1 + 2 * ST) + 1024;  // + alignment slack
};

// Of the dk/dv kernel: K and V, the Q and dO ring with each tile's lse and
// delta, the barriers.
template <int ST>
struct DkvSmem {
  static constexpr int k = 0;
  static constexpr int v = k + BOX * 2;
  static constexpr int q = v + BOX * 2;
  static constexpr int dout = q + ST * BOX * 2;
  static constexpr int lse = dout + ST * BOX * 2;
  static constexpr int dlt = lse + ST * ROWS * 4;
  static constexpr int bars = dlt + ST * ROWS * 4;  // kvbar, full[ST], empty[ST]
  static constexpr int bytes = bars + 8 * (1 + 2 * ST) + 1024;
};

// A call's launch plan: the Q and KV tiles, and how the dk/dv kernel's Q
// walk is split. The split is taken where the dk/dv grid is under one
// block an SM, towards one block an SM, each split walking at least
// SPLIT_MIN_TILES Q tiles.
struct Plan {
  int nq, nkv;      // Q tiles of 64 rows, KV tiles of 64 rows
  int sqp, skvp;    // Sq and Skv rounded up to 64
  int split, tps;   // Q-walk splits, Q tiles a split
  dim3 dq_grid, dkv_grid;
};

inline Plan plan(int B, int H, int Sq, int Skv) {
  Plan p;
  p.nq = (Sq + ROWS - 1) / ROWS;
  p.nkv = (Skv + ROWS - 1) / ROWS;
  p.sqp = p.nq * ROWS;
  p.skvp = p.nkv * ROWS;
  const int blocks = p.nkv * H * B;
  int split = 1;
  if (blocks < NUM_SMS) {
    const int want = (NUM_SMS + blocks - 1) / blocks;
    split = std::max(1, std::min(want, p.nq / SPLIT_MIN_TILES));
  }
  p.tps = (p.nq + split - 1) / split;
  p.split = (p.nq + p.tps - 1) / p.tps;
  p.dq_grid = dim3(p.nq, H, B);
  p.dkv_grid = dim3(p.nkv, H, B * p.split);
  return p;
}

// Scratch: lse * log2(e) and delta as (B, H, Sqp) fp32, then, for a split
// walk, the partial dK and dV as (split, B, Skvp, H*64) fp32 each.
inline size_t workspace_floats(const Plan& p, int B, int H) {
  size_t n = 2 * (size_t)B * H * p.sqp;
  if (p.split > 1) n += 2 * (size_t)p.split * B * p.skvp * H * HD;
  return n;
}

struct Args {
  bf16* dq;
  bf16* dk;
  bf16* dv;
  const float* lse2;   // (B, H, Sqp): lse * log2(e), 0 past Sq
  const float* delta;  // (B, H, Sqp), 0 past Sq
  float* part;         // split partials: dK, then dV
  int B, H, Sq, Skv, sqp, skvp, D;
  int nq, split, tps;
  float scale, scale_log2;
};

// delta = rowsum(dO * O) over each head's 64 columns, from 16-byte loads (8
// threads a row), and lse * log2(e), both written as (B, H, Sqp), 0 past Sq.
__global__ void __launch_bounds__(256)
prologue_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ lse2,
                float* __restrict__ delta, int B, int H, int Sq, int sqp) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = gid >> 3, rows = (long long)B * sqp * H;
  const int sub = (int)(gid & 7);
  const int h = (int)(row % H);
  const int s = (int)((row / H) % sqp);
  const int b = (int)(row / ((long long)H * sqp));
  const bool in = row < rows && s < Sq;
  float acc = 0.f;
  if (in) {
    const size_t off = ((size_t)b * Sq + s) * H * HD + h * HD + sub * 8;
    Pack8 ov, dv;
    ov.u = *reinterpret_cast<const uint4*>(o + off);
    dv.u = *reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc += __bfloat162float(ov.h[e]) * __bfloat162float(dv.h[e]);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (row < rows && sub == 0) {
    const size_t idx = ((size_t)b * H + h) * sqp + s;
    delta[idx] = in ? acc : 0.f;
    lse2[idx] = in ? lse[((size_t)b * Sq + s) * H + h] * LOG2E : 0.f;
  }
}

// Byte offset of the 4-byte pair at (row r, column c) of a 64 x 64 bf16
// tile staged for a 16-byte-row store: the 16-byte chunks of row r are
// permuted by r % 8, so that a warp's fragment writes hit 32 banks.
__device__ __forceinline__ int staged(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2;
}

// Round a warpgroup's 64 x 64 fp32 accumulator times `mul` to bf16 into the
// staged tile `st` (thread `ct` of the warpgroup, accumulator layout), then,
// after the warpgroup's barrier, store rows below `limit` of it to `out`
// (rows `ld` elements apart) in 16-byte rows. `st` is a tile the
// warpgroup's wgmmas read: the first barrier waits for every warp's.
__device__ __forceinline__ void store_staged(const float (&acc)[32], float mul, unsigned char* st,
                                             bf16* out, size_t ld, int limit, int ct) {
  const int w = ct >> 5, lane = ct & 31, t = lane & 3;
  i2i::named_bar_sync(1, 128);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * w + (lane >> 2) + 8 * hh;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(st + staged(r, 8 * j + 2 * t)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh] * mul, acc[4 * j + 2 * hh + 1] * mul);
  }
  i2i::named_bar_sync(1, 128);
#pragma unroll
  for (int i = ct; i < ROWS * 8; i += 128) {
    const int r = i >> 3, c = (i & 7) * 8;
    if (r < limit)
      *reinterpret_cast<uint4*>(out + r * ld + c) =
          *reinterpret_cast<const uint4*>(st + staged(r, c));
  }
}

// Pack an accumulator (64 x 16n fp32) into register-A fragments of bf16
// pairs: the k16 chunk kc is registers 8kc .. 8kc+7.
template <int N>
__device__ __forceinline__ void to_frag(const float (&acc)[N / 2], uint32_t (&fr)[N / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(acc[8 * kc + 2 * r], acc[8 * kc + 2 * r + 1]);
      fr[kc][r] = *reinterpret_cast<const uint32_t*>(&v);
    }
}

// D (64 x N fp32) = or += A B, both operands K-major in shared memory.
template <int N>
__device__ __forceinline__ void mma_ss(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 128)
    i2i::wgmma_m64n128k16_ss(d, da, db, scale_d);
  else
    i2i::wgmma_m64n64k16_ss(d, da, db, scale_d);
}

template <int BKV, int ST, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
          const Args a) {
  using L = DqSmem<BKV, ST>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (i2i::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::dout);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  float* lses = reinterpret_cast<float*>(smem + L::lse);
  float* dlts = reinterpret_cast<float*>(smem + L::dlt);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int col0 = h * HD;
  const int ntiles = (a.Skv + BKV - 1) / BKV;

  if (tid == 0) {
    i2i::mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      i2i::mbar_init(&full[s], 1);
      i2i::mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    i2i::fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4) {  // ---- producer: one thread issues every load
    if (lane == 0) {
      const size_t srow = ((size_t)b * a.H + h) * a.sqp + q0;
      i2i::mbar_arrive_expect_tx(qbar, 2 * BOX * 2 + 2 * ROWS * 4);
      i2i::tma_load_3d(Qs, &qmap, qbar, col0, q0, b);
      i2i::tma_load_3d(dOs, &dmap, qbar, col0, q0, b);
      i2i::bulk_load(lses, a.lse2 + srow, ROWS * 4, qbar);
      i2i::bulk_load(dlts, a.delta + srow, ROWS * 4, qbar);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % ST;
        i2i::mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);  // round 0 passes at once
        i2i::mbar_arrive_expect_tx(&full[s], 2 * BKV * HD * 2);
#pragma unroll
        for (int c = 0; c < BKV / ROWS; ++c) {
          i2i::tma_load_3d(Ks + s * BKV * HD + c * BOX, &kmap, &full[s], col0,
                           i * BKV + c * ROWS, b);
          i2i::tma_load_3d(Vs + s * BKV * HD + c * BOX, &vmap, &full[s], col0,
                           i * BKV + c * ROWS, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup: warp w owns rows q0 + 16 w .. + 15; register
  // 4j+2hh+e of an accumulator is row 16 w + lane/4 + 8 hh, column 8j + 2t + e
  const int t = lane & 3;
  float dq[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) dq[r] = 0.f;
  i2i::mbar_wait(qbar, 0);
  float l2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + (lane >> 2) + 8 * hh;
    l2[hh] = lses[r];
    dl[hh] = dlts[r];
  }

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % ST;
    i2i::mbar_wait(&full[s], (i / ST) & 1);
    const bf16* ks = Ks + s * BKV * HD;
    const bf16* vs = Vs + s * BKV * HD;

    // S = Q K^T, then dP = dO V^T, two groups
    float sc[BKV / 2], dp[BKV / 2];
    i2i::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss<BKV>(sc, i2i::smem_desc_sw128(Qs + kk * 16, 16),
                  i2i::smem_desc_sw128(ks + kk * 16, 16), kk > 0);
    i2i::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss<BKV>(dp, i2i::smem_desc_sw128(dOs + kk * 16, 16),
                  i2i::smem_desc_sw128(vs + kk * 16, 16), kk > 0);
    i2i::wgmma_commit();

    // P = exp2(S scale log2(e) - lse log2(e)), 0 past Skv, while dP runs
    i2i::wgmma_wait<1>();
    i2i::reg_fence(sc);
    const int kv0 = i * BKV;
    const bool ragged = kv0 + BKV > a.Skv;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * hh + e;
          const float p = exp2f(fmaf(sc[x], a.scale_log2, -l2[hh]));
          sc[x] = ragged && kv0 + 8 * j + 2 * t + e >= a.Skv ? 0.f : p;
        }
    // dS = P (dP - delta)
    i2i::wgmma_wait<0>();
    i2i::reg_fence(dp);
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * hh + e;
          sc[x] *= dp[x] - dl[hh];
        }
    uint32_t dsf[BKV / 16][4];
    to_frag<BKV>(sc, dsf);

    // dQ += dS K; K is MN-major here, its 64 columns one block
    i2i::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc)
      i2i::wgmma_m64n64k16_rs_tb(dq, dsf[kc], i2i::smem_desc_sw128(ks + kc * 16 * HD, BKV * 128));
    i2i::wgmma_commit();
    i2i::wgmma_wait<0>();
    i2i::reg_fence(dq);
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) i2i::reg_fence(dsf[kc]);
    __syncwarp();
    if (lane == 0) i2i::mbar_arrive(&empty[s]);  // this warp is done with stage s
  }

  // ---- epilogue: dQ * scale, one rounding, staged in Q's tile
  store_staged(dq, a.scale, smem + L::q, a.dq + ((size_t)b * a.Sq + q0) * a.D + col0, a.D,
               a.Sq - q0, tid);
}

template <int ST, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
dkv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
           const Args a) {
  using L = DkvSmem<ST>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (i2i::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::dout);
  float* lses = reinterpret_cast<float*>(smem + L::lse);
  float* dlts = reinterpret_cast<float*>(smem + L::dlt);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kv0 = blockIdx.x * ROWS, h = blockIdx.y;
  const int b = blockIdx.z / a.split, sp = blockIdx.z % a.split;
  const int col0 = h * HD;
  const int qt0 = sp * a.tps;
  const int ntiles = min(a.nq - qt0, a.tps);

  if (tid == 0) {
    i2i::mbar_init(kvbar, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      i2i::mbar_init(&full[s], 1);
      i2i::mbar_init(&empty[s], 4);
    }
    i2i::fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4) {  // ---- producer
    if (lane == 0) {
      i2i::mbar_arrive_expect_tx(kvbar, 2 * BOX * 2);
      i2i::tma_load_3d(Ks, &kmap, kvbar, col0, kv0, b);
      i2i::tma_load_3d(Vs, &vmap, kvbar, col0, kv0, b);
      const size_t srow = ((size_t)b * a.H + h) * a.sqp;
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % ST, q0 = (qt0 + i) * ROWS;
        i2i::mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        i2i::mbar_arrive_expect_tx(&full[s], 2 * BOX * 2 + 2 * ROWS * 4);
        i2i::tma_load_3d(Qs + s * BOX, &qmap, &full[s], col0, q0, b);
        i2i::tma_load_3d(dOs + s * BOX, &dmap, &full[s], col0, q0, b);
        i2i::bulk_load(lses + s * ROWS, a.lse2 + srow + q0, ROWS * 4, &full[s]);
        i2i::bulk_load(dlts + s * ROWS, a.delta + srow + q0, ROWS * 4, &full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroup: warp w owns KV rows kv0 + 16 w .. + 15; the
  // columns of S^T and dP^T are the tile's Q rows
  const int t = lane & 3;
  float dk[32], dv[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) dk[r] = dv[r] = 0.f;
  i2i::mbar_wait(kvbar, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % ST;
    i2i::mbar_wait(&full[s], (i / ST) & 1);
    const bf16* qs = Qs + s * BOX;
    const bf16* ds = dOs + s * BOX;
    const float* ls = lses + s * ROWS;
    const float* dls = dlts + s * ROWS;

    // S^T = K Q^T and dP^T = V dO^T, one group
    float st[32], dpt[32];
    i2i::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      i2i::wgmma_m64n64k16_ss(st, i2i::smem_desc_sw128(Ks + kk * 16, 16),
                              i2i::smem_desc_sw128(qs + kk * 16, 16), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      i2i::wgmma_m64n64k16_ss(dpt, i2i::smem_desc_sw128(Vs + kk * 16, 16),
                              i2i::smem_desc_sw128(ds + kk * 16, 16), kk > 0);
    i2i::wgmma_commit();
    i2i::wgmma_wait<0>();
    i2i::reg_fence(st);
    i2i::reg_fence(dpt);

    // P^T and dS^T: column 8j + 2t + e is Q row q0 + 8j + 2t + e
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l2 = ls[8 * j + 2 * t + e], dl = dls[8 * j + 2 * t + e];
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
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      i2i::wgmma_m64n64k16_rs_tb(dk, dsf[kc], i2i::smem_desc_sw128(qs + kc * 16 * HD, ROWS * 128));
    i2i::wgmma_commit();
    i2i::wgmma_wait<0>();
    i2i::reg_fence(dv);
    i2i::reg_fence(dk);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      i2i::reg_fence(pf[kc]);
      i2i::reg_fence(dsf[kc]);
    }
    __syncwarp();
    if (lane == 0) i2i::mbar_arrive(&empty[s]);
  }

  if (a.split == 1) {
    // ---- dK * scale and dV, one rounding each, staged in K's and V's tiles
    const size_t off = ((size_t)b * a.Skv + kv0) * a.D + col0;
    store_staged(dk, a.scale, smem + L::k, a.dk + off, a.D, a.Skv - kv0, tid);
    store_staged(dv, 1.f, smem + L::v, a.dv + off, a.D, a.Skv - kv0, tid);
    return;
  }
  // ---- a split: fp32 partials for dkv_reduce, (split, B, Skvp, D) each
  const size_t plane = (size_t)a.B * a.skvp * a.D;
  float* pk = a.part + sp * plane + ((size_t)b * a.skvp + kv0) * a.D + col0;
  float* pv = pk + a.split * plane;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + (lane >> 2) + 8 * hh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const size_t x = (size_t)r * a.D + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(pk + x) = make_float2(dk[4 * j + 2 * hh], dk[4 * j + 2 * hh + 1]);
      *reinterpret_cast<float2*>(pv + x) = make_float2(dv[4 * j + 2 * hh], dv[4 * j + 2 * hh + 1]);
    }
  }
}

// dK = scale * sum of the splits' partials and dV = their sum, added in
// split order (no atomics: bit-identical from call to call), rounded once;
// 8 columns a thread.
__global__ void __launch_bounds__(256)
dkv_reduce(const float* __restrict__ part, bf16* __restrict__ dk, bf16* __restrict__ dv, int B,
           int Skv, int skvp, int D, int split, float scale) {
  const size_t n = (size_t)B * Skv * D / 8;
  const size_t plane = (size_t)B * skvp * D;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = i * 8;
    const size_t b = e / ((size_t)Skv * D), rem = e % ((size_t)Skv * D);
    const size_t src = (b * skvp + rem / D) * D + rem % D;
    float sk[8], sv[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) sk[c] = sv[c] = 0.f;
    for (int sp = 0; sp < split; ++sp) {
      const float4* pk = reinterpret_cast<const float4*>(part + sp * plane + src);
      const float4* pv = reinterpret_cast<const float4*>(part + (split + sp) * plane + src);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 k4 = pk[c], v4 = pv[c];
        sk[4 * c] += k4.x, sk[4 * c + 1] += k4.y, sk[4 * c + 2] += k4.z, sk[4 * c + 3] += k4.w;
        sv[4 * c] += v4.x, sv[4 * c + 1] += v4.y, sv[4 * c + 2] += v4.z, sv[4 * c + 3] += v4.w;
      }
    }
    Pack8 ok, ov;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      ok.h[c] = __float2bfloat16(sk[c] * scale);
      ov.h[c] = __float2bfloat16(sv[c]);
    }
    *reinterpret_cast<uint4*>(dk + e) = ok.u;
    *reinterpret_cast<uint4*>(dv + e) = ov.u;
  }
}

int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
           const float* lse, float* ws, bf16* dq, bf16* dk, bf16* dv, int B, int Sq, int Skv,
           int H, cudaStream_t stream) {
  using DqL = DqSmem<DQ_BKV, DQ_ST>;
  using DkvL = DkvSmem<DKV_ST>;
  auto dqk = dq_kernel<DQ_BKV, DQ_ST, DQ_MINB>;
  auto dkvk = dkv_kernel<DKV_ST, DKV_MINB>;
  static thread_local int smem_set_on = -1;  // the device it was last set on
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != smem_set_on) {
    err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, DqL::bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dkvk, cudaFuncAttributeMaxDynamicSharedMemorySize, DkvL::bytes);
    if (err == cudaSuccess) smem_set_on = dev;
  }
  if (err != cudaSuccess) return (int)err;
  const int D = H * HD;
  CUtensorMap maps[4];  // q, k, v, dO: boxes of 64 rows
  int e = i2i::tensor_map_3d(&maps[0], q, D, Sq, B, ROWS);
  if (!e) e = i2i::tensor_map_3d(&maps[1], k, D, Skv, B, ROWS);
  if (!e) e = i2i::tensor_map_3d(&maps[2], v, D, Skv, B, ROWS);
  if (!e) e = i2i::tensor_map_3d(&maps[3], dout, D, Sq, B, ROWS);
  if (e) return e;

  const Plan p = plan(B, H, Sq, Skv);
  Args a;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.lse2 = ws;
  a.delta = ws + (size_t)B * H * p.sqp;
  a.part = ws + 2 * (size_t)B * H * p.sqp;
  a.B = B;
  a.H = H;
  a.Sq = Sq;
  a.Skv = Skv;
  a.sqp = p.sqp;
  a.skvp = p.skvp;
  a.D = D;
  a.nq = p.nq;
  a.split = p.split;
  a.tps = p.tps;
  a.scale = 1.0f / sqrtf((float)HD);
  a.scale_log2 = a.scale * LOG2E;

  const long long pro_threads = (long long)B * p.sqp * H * 8;
  prologue_kernel<<<(unsigned)((pro_threads + 255) / 256), 256, 0, stream>>>(
      o, dout, lse, ws, ws + (size_t)B * H * p.sqp, B, H, Sq, p.sqp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dqk<<<p.dq_grid, THREADS, DqL::bytes, stream>>>(maps[0], maps[1], maps[2], maps[3], a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dkvk<<<p.dkv_grid, THREADS, DkvL::bytes, stream>>>(maps[0], maps[1], maps[2], maps[3], a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (p.split > 1) {
    const size_t n = (size_t)B * Skv * D / 8;
    const unsigned blocks = (unsigned)std::min<size_t>((n + 255) / 256, 8 * NUM_SMS);
    dkv_reduce<<<blocks, 256, 0, stream>>>(a.part, dk, dv, B, Skv, p.skvp, D, p.split, a.scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace h64

}  // namespace

extern "C" {

// q, o, dout: (B, Sq, H*hd); k, v: (B, Skv, H*hd), all bf16 and 16-byte
// aligned; lse: (B, Sq, H) fp32 from the forward; workspace: fp32 scratch of
// flash_attention_bwd_workspace_bytes(B, Sq, Skv, H, hd) bytes, 16-byte
// aligned. Writes dq (B, Sq, H*hd), dk and dv (B, Skv, H*hd), bf16. hd must
// be 64 or 512. Returns cudaGetLastError(), or TENSOR_MAP_ERROR + the
// CUresult of a refused tensor map.
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* workspace, void* dq, void* dk, void* dv, int B,
                             int Sq, int Skv, int H, int hd, void* stream) {
  auto* qq = static_cast<const bf16*>(q);
  auto* kk = static_cast<const bf16*>(k);
  auto* vv = static_cast<const bf16*>(v);
  auto* oo = static_cast<const bf16*>(o);
  auto* gg = static_cast<const bf16*>(dout);
  auto* ll = static_cast<const float*>(lse);
  auto* ws = static_cast<float*>(workspace);
  auto* gq = static_cast<bf16*>(dq);
  auto* gk = static_cast<bf16*>(dk);
  auto* gv = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return h64::launch(qq, kk, vv, oo, gg, ll, ws, gq, gk, gv, B, Sq, Skv, H, s);
  if (hd == 512)  // ws: delta, (B, Sq, H) fp32
    return launch<512, 32, 32, 64, 16>(qq, kk, vv, oo, gg, ll, ws, gq, gk, gv,
                                       B, Sq, Skv, H, s);
  return (int)cudaErrorInvalidValue;
}

// The workspace a call needs, in bytes: at hd 64 the relaid lse and delta
// and, for a split Q walk, the partial dK and dV; at hd 512 delta. 0 for a
// head dim the kernels do not take.
long long flash_attention_bwd_workspace_bytes(int B, int Sq, int Skv, int H, int hd) {
  if (hd == 64) return 4 * (long long)h64::workspace_floats(h64::plan(B, H, Sq, Skv), B, H);
  if (hd == 512) return 4LL * B * Sq * H;
  return 0;
}

// The launch plan of a call, for run reports: plan[0..2] the dq grid,
// plan[3] its Q rows a block, plan[4] its KV rows a tile, plan[5] its ring
// stages (0: no ring); plan[6..8] the dk/dv grid, plan[9] its KV rows a
// block, plan[10] its Q rows a tile, plan[11] its ring stages; plan[12] the
// splits of the Q walk, plan[13] the Q tiles a split walks; plan[14] the
// kernels a call launches. Returns 0, or cudaErrorInvalidValue for a head
// dim the kernels do not take.
int flash_attention_bwd_plan(int B, int H, int Sq, int Skv, int hd, int* plan) {
  if (hd == 64) {
    const h64::Plan p = h64::plan(B, H, Sq, Skv);
    const int v[15] = {(int)p.dq_grid.x, (int)p.dq_grid.y, (int)p.dq_grid.z, h64::ROWS,
                       h64::DQ_BKV, h64::DQ_ST, (int)p.dkv_grid.x, (int)p.dkv_grid.y,
                       (int)p.dkv_grid.z, h64::ROWS, h64::ROWS, h64::DKV_ST, p.split, p.tps,
                       p.split > 1 ? 4 : 3};
    for (int i = 0; i < 15; ++i) plan[i] = v[i];
    return 0;
  }
  if (hd == 512) {
    const int nq = (Sq + 63) / 64;
    const int v[15] = {(Sq + 31) / 32, H, B, 32, 32, 0, (Skv + 15) / 16, H, B, 16, 64, 0, 1,
                       nq, 2};
    for (int i = 0; i < 15; ++i) plan[i] = v[i];
    return 0;
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
