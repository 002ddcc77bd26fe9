// Flash attention backward on folded (B, S, H*hd) tensors: kernel K7 of the
// TPU package, for Hopper (sm_90a).
//
// Replaces img2img_turbo_tpu/ops/attention.py:390 flash_attention_folded_bwd
// (bodies _flash_bwd_dq_kernel :302 and _flash_bwd_dkv_kernel :341). The
// (Sq, Skv) probabilities never reach device memory: each block rebuilds its
// tile of P = exp(S * scale - lse) from the forward's saved logsumexp, and
// forms dP = dO V^T and dS = P * (dP - delta), delta = rowsum(dO * O).
//
// Two kernels, as in the JAX design, and no atomics, so a repeated step is
// bit-identical:
//   dq:  one block per (Q block, head, batch) walks every KV block and
//        accumulates dQ = dS K * scale. It also computes delta for its rows
//        and writes it for the second kernel;
//   dkv: one block per (KV block, head, batch) walks every Q block and
//        accumulates dV = P^T dO and dK = dS^T Q * scale.
// P and dS are rounded to bf16 before their products, as the TPU kernels
// round them; all sums are fp32. Ragged Sq and Skv are masked in the
// kernels (the TPU version pads): rows past Sq have P = dS = 0, columns
// past Skv have P = 0, and neither is stored.
//
// Products run on bf16 tensor-core MMAs (wmma, fp32 accumulate). Each warp
// keeps its share of the dQ (or dK, dV) accumulator tiles in registers for
// the whole walk, so at hd = 512 the accumulators are split by column
// chunks of 16 over the block's 8 warps (8 tiles a warp); S, dP, P and dS
// live in shared memory between the phases.
//
// What bounds it on the H100: the work is 5 products of Sq x Skv x hd per
// head (2.5x the forward), so at hd = 64 and S = 4096 it is
// compute-bound; this first version re-reads the walked operand from L2 for
// every block, synchronises between the phases and uses wmma rather than
// wgmma, so it runs well below the tensor-core rate. wgmma and TMA are
// later work.

#include "common.cuh"

using namespace nvcuda;
using i2i::bf16;
using i2i::Pack8;

namespace {

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

}  // namespace

extern "C" {

// q, o, dout: (B, Sq, H*hd); k, v: (B, Skv, H*hd), all bf16; lse: (B, Sq, H)
// fp32 from the forward; delta: (B, Sq, H) fp32 scratch, written by the dq
// kernel. Writes dq (B, Sq, H*hd), dk and dv (B, Skv, H*hd), bf16. hd must
// be 64 or 512. Returns cudaGetLastError().
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* delta, void* dq, void* dk, void* dv, int B,
                             int Sq, int Skv, int H, int hd, void* stream) {
  auto* qq = static_cast<const bf16*>(q);
  auto* kk = static_cast<const bf16*>(k);
  auto* vv = static_cast<const bf16*>(v);
  auto* oo = static_cast<const bf16*>(o);
  auto* gg = static_cast<const bf16*>(dout);
  auto* ll = static_cast<const float*>(lse);
  auto* dd = static_cast<float*>(delta);
  auto* gq = static_cast<bf16*>(dq);
  auto* gk = static_cast<bf16*>(dk);
  auto* gv = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<64, 64, 64, 64, 64>(qq, kk, vv, oo, gg, ll, dd, gq, gk, gv,
                                      B, Sq, Skv, H, s);
  if (hd == 512)
    return launch<512, 32, 32, 64, 16>(qq, kk, vv, oo, gg, ll, dd, gq, gk, gv,
                                       B, Sq, Skv, H, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
