// Flash attention backward on folded (B, S, H*hd) tensors: kernel K7 of the
// TPU package, for Hopper (sm_90a).
//
// Replaces img2img_turbo_tpu/ops/attention.py:390 flash_attention_folded_bwd
// (bodies _flash_bwd_dq_kernel :302 and _flash_bwd_dkv_kernel :341, delta in
// XLA at :398-400). P = exp(S * scale - lse) is rebuilt from the forward's
// saved logsumexp, dP = dO V^T and dS = P * (dP - delta), delta =
// rowsum(dO * O); dQ = scale dS K, dK = scale dS^T Q and dV = P^T dO. P and
// dS are rounded to bf16 before their products, as the TPU kernels round
// them; all sums are fp32; each output is rounded once. Ragged Sq and Skv
// are masked in the kernels (the TPU version pads). No atomics, so a
// repeated step is bit-identical.
//
// Both head dims start with one prologue: delta = rowsum(dO * O) from
// 16-byte loads, written with lse * log2(e) as (B, H, Sqp) fp32 scratch (Sqp
// = Sq rounded up to the Q tile, zero past Sq), so that a Q tile's values of
// one head are one contiguous row a TMA bulk copy reads (lse arrives as (B,
// Sq, H), where they lie at stride H).
//
// hd = 64 (the UNet's self- and cross-attention): the (Sq, Skv)
// probabilities never reach device memory. Two kernels, as in the JAX
// design; S and dP are computed in both (7 products of Sq x Skv x hd per
// head against the least 5):
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
//
// hd = 512 (the VAE mid attention, one head at S = 4096 in a train step):
// a 64 x 512 fp32 accumulator is 256 registers a thread of a warpgroup, so
// dK and dV cannot stay resident beside S and dP as at hd 64, and column
// slices of the head would recompute S and dP once per slice (at least 15
// products against 5). Instead P and dS go through device memory once, in
// bf16, and the call runs the least 5 products in two kernels:
//   scores:   a block per 128 x 128 tile of (Q rows, KV rows) of one (b, h),
//        two consumer warpgroups (64 Q rows each) and a TMA producer warp
//        streaming 64-column chunks of Q, dO, K and V through a 3-stage
//        ring. wgmma accumulates S = Q K^T and dP = dO V^T over the head's 8
//        chunks in registers; the epilogue forms P and dS (exp2f, the row's
//        lse and delta, P = 0 past Skv and past Sq), rounds them to bf16
//        and stores both tiles, staged in shared memory, to a workspace of
//        (B*H, Sq', Skv') bf16 planes (the lengths rounded up to 128);
//   products: one launch runs dQ = scale dS K (M = Sq, contraction Skv),
//        dK = scale dS^T Q and dV = P^T dO (M = Skv, contraction Sq) as
//        128 x 128 output tiles (hd in 4 column tiles), two consumer
//        warpgroups and a producer warp with a 4-stage TMA ring of 64-row
//        steps. dS^T and P^T are read as MN-major A operands straight from
//        the workspace's tiles, Q, K and dO as MN-major B operands, so
//        nothing is transposed in device memory. Each epilogue scales,
//        rounds once and stores 16-byte rows staged in shared memory.
//   bands: where P and dS would pass 256 MiB (S = 16384, the VAE mid
//        attention of a 1024^2 image), the call walks bands of Q rows, a
//        scores and a products launch each: dQ is complete per band, dK
//        and dV are summed across bands in fp32 scratch, in band order,
//        and rounded once after the last.
// A call's launch plan (tiles, stages, split or bands, grids) lives only
// here (flash_attention_bwd_plan reports it), and so does its scratch size
// (flash_attention_bwd_workspace_bytes).
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
// their launches (three or four kernels of a few microseconds). At hd 512
// the scores kernel reads each Q, dO, K and V chunk once per tile pair
// (about 0.5 GiB from L2 at S = 4096) and writes 64 MiB of P and dS; the
// products kernel reads them back 4 times (once per column tile).

#include <algorithm>

#include "hopper.cuh"

using i2i::bf16;
using i2i::Pack8;

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// delta = rowsum(dO * O) over each head's HD columns, from 16-byte loads
// (HD / 8 threads a row, at most a warp, each summing its chunks in order),
// and lse * log2(e), both written as (B, H, Sqp), 0 past Sq.
template <int HD>
__global__ void __launch_bounds__(256)
prologue_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ lse2,
                float* __restrict__ delta, int B, int H, int Sq, int sqp) {
  constexpr int TPR = HD / 8 < 32 ? HD / 8 : 32;  // threads a row
  constexpr int CH = HD / (8 * TPR);              // 16-byte chunks a thread
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = gid / TPR, rows = (long long)B * sqp * H;
  const int sub = (int)(gid % TPR);
  const int h = (int)(row % H);
  const int s = (int)((row / H) % sqp);
  const int b = (int)(row / ((long long)H * sqp));
  const bool in = row < rows && s < Sq;
  float acc = 0.f;
  if (in) {
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const size_t off = ((size_t)b * Sq + s) * H * HD + h * HD + (ch * TPR + sub) * 8;
      Pack8 ov, dv;
      ov.u = *reinterpret_cast<const uint4*>(o + off);
      dv.u = *reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc += __bfloat162float(ov.h[e]) * __bfloat162float(dv.h[e]);
    }
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && sub == 0) {
    const size_t idx = ((size_t)b * H + h) * sqp + s;
    delta[idx] = in ? acc : 0.f;
    lse2[idx] = in ? lse[((size_t)b * Sq + s) * H + h] * LOG2E : 0.f;
  }
}

template <int HD>
cudaError_t launch_prologue(const bf16* o, const bf16* dout, const float* lse, float* lse2,
                            float* delta, int B, int H, int Sq, int sqp, cudaStream_t stream) {
  constexpr int TPR = HD / 8 < 32 ? HD / 8 : 32;
  const long long threads = (long long)B * sqp * H * TPR;
  prologue_kernel<HD><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      o, dout, lse, lse2, delta, B, H, Sq, sqp);
  return cudaGetLastError();
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

  if ((err = launch_prologue<HD>(o, dout, lse, ws, ws + (size_t)B * H * p.sqp, B, H, Sq, p.sqp,
                                 stream)) != cudaSuccess)
    return (int)err;
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

// ---------------------------------------------------------------------------
// hd = 512: a scores kernel and a products kernel, wgmma fed by TMA
// ---------------------------------------------------------------------------

namespace h512 {

constexpr int HD = 512;
constexpr int TILE = 128;          // Q and KV rows of a scores tile; rows and columns of a product tile
constexpr int BOX = 64 * 64;       // elements of a TMA box (64 rows of 64 columns): 8 KB
constexpr int THREADS = 256 + 32;  // two consumer warpgroups, one producer warp
constexpr int CHUNKS = HD / 64;    // 64-column chunks of a head
constexpr int SC_ST = 3;           // scores ring stages, 64 KB each
constexpr int PR_ST = 4;           // products ring stages, 32 KB each
constexpr int PR_K = 64;           // contraction rows a products step
constexpr long long BAND_BYTES = 256LL << 20;  // P and dS of a band at most

// Shared memory of the scores kernel: the ring (a stage holds 128 rows of a
// 64-column chunk of Q, dO, K and V, as two boxes each), the tile's lse and
// delta, the barriers. After the chunks, the ring stages P and dS.
struct ScSmem {
  static constexpr int stage = 8 * BOX * 2;
  static constexpr int lse = SC_ST * stage;
  static constexpr int dlt = lse + TILE * 4;
  static constexpr int bars = dlt + TILE * 4;  // lbar, full[ST], empty[ST]
  static constexpr int bytes = bars + 8 * (1 + 2 * SC_ST) + 1024;  // + alignment slack
};
// Of the products kernel: the ring (a stage holds the step's A as two boxes,
// one a warpgroup, and its B as two 64-column boxes), each warpgroup's
// output staging tile (64 x 128 bf16), the barriers.
struct PrSmem {
  static constexpr int stage = 4 * BOX * 2;
  static constexpr int out = PR_ST * stage;
  static constexpr int bars = out + 2 * 64 * TILE * 2;  // full[ST], empty[ST]
  static constexpr int bytes = bars + 8 * 2 * PR_ST + 1024;
};

// A call's plan: the lengths rounded up to the tile, and the bands of Q
// rows (each a multiple of 128 rows, the last maybe shorter) whose P and dS
// fit in BAND_BYTES.
struct Plan {
  int sqp, skvp, nkv;
  int bands, band_rows;
};

inline Plan plan(int B, int H, int Sq, int Skv) {
  Plan p;
  p.sqp = (Sq + TILE - 1) / TILE * TILE;
  p.skvp = (Skv + TILE - 1) / TILE * TILE;
  p.nkv = p.skvp / TILE;
  const long long row_bytes = 2LL * B * H * p.skvp * 2;  // P and dS of a Q row
  const long long fit = std::max<long long>(TILE, BAND_BYTES / row_bytes / TILE * TILE);
  p.bands = (int)((p.sqp + fit - 1) / fit);
  const int per = (p.sqp + p.bands - 1) / p.bands;
  p.band_rows = (per + TILE - 1) / TILE * TILE;
  return p;
}

// Q tiles of band `band`
inline int band_tiles(const Plan& p, int band) {
  return std::min(p.band_rows, p.sqp - band * p.band_rows) / TILE;
}

// Scratch: lse * log2(e) and delta as (B, H, Sqp) fp32; P and dS as
// (B*H, band_rows, Skvp) bf16 each; for a banded call, the fp32 sums of dK
// and dV over the bands before, (B, Skv, H*512) each.
inline size_t workspace_bytes(const Plan& p, int B, int H, int Skv) {
  size_t n = 2 * 4 * (size_t)B * H * p.sqp + 2 * 2 * (size_t)B * H * p.band_rows * p.skvp;
  if (p.bands > 1) n += 2 * 4 * (size_t)B * Skv * H * HD;
  return n;
}

struct Args {
  bf16* dq;
  bf16* dk;
  bf16* dv;
  const float* lse2;   // (B, H, Sqp): lse * log2(e), 0 past Sq
  const float* delta;  // (B, H, Sqp), 0 past Sq
  bf16* p;             // (B*H, band_rows, Skvp) P, 0 past Sq and Skv
  bf16* ds;            // the same for dS
  float* acc;          // banded calls: dK's fp32 sum, then dV's, (B, Skv, D) each
  int B, H, Sq, Skv, sqp, skvp, D;
  int band, bands, q0, ntq;  // the band, of `bands`; its first Q row; its Q tiles
  int band_rows;
  float scale, scale_log2;
};

// Byte offset of the 4-byte pair at (row r, column c) of a 64 x 128 bf16
// tile staged for 16-byte-row stores: the 16-byte chunks of row r are
// permuted by r % 8, so that a warp's fragment writes hit 32 banks.
__device__ __forceinline__ int staged(int r, int c) {
  return r * 256 + ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2;
}

// Round a warpgroup's 64 x 128 accumulator (times `mul`) into `st` in the
// staged layout (thread `ct` of the warpgroup, accumulator layout).
__device__ __forceinline__ void stage_tile(const float (&acc)[64], float mul, unsigned char* st,
                                           int ct) {
  const int w = ct >> 5, lane = ct & 31, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * w + (lane >> 2) + 8 * hh;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(st + staged(r, 8 * j + 2 * t)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh] * mul, acc[4 * j + 2 * hh + 1] * mul);
  }
}

// Store rows below `limit` of a staged 64 x 128 tile to `out` (rows `ld`
// elements apart) in 16-byte rows.
__device__ __forceinline__ void store_rows(const unsigned char* st, bf16* out, size_t ld,
                                           int limit, int ct) {
#pragma unroll 4
  for (int i = ct; i < 64 * 16; i += 128) {
    const int r = i >> 4, c = (i & 15) * 8;
    if (r < limit)
      *reinterpret_cast<uint4*>(out + r * ld + c) =
          *reinterpret_cast<const uint4*>(st + staged(r, c));
  }
}

__global__ void __launch_bounds__(THREADS, 1)
scores_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
              const Args a) {
  using L = ScSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (i2i::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* lses = reinterpret_cast<float*>(smem + L::lse);
  float* dlts = reinterpret_cast<float*>(smem + L::dlt);
  uint64_t* lbar = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = lbar + 1;
  uint64_t* empty = full + SC_ST;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kv0 = blockIdx.x * TILE, qr = blockIdx.y * TILE, bh = blockIdx.z;
  const int b = bh / a.H, h = bh % a.H, col0 = h * HD;
  const int q0 = a.q0 + qr;  // the tile's first Q row

  if (tid == 0) {
    i2i::mbar_init(lbar, 1);
#pragma unroll
    for (int s = 0; s < SC_ST; ++s) {
      i2i::mbar_init(&full[s], 1);
      i2i::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    i2i::fence_mbar_init();
  }
  __syncthreads();

  if (warp == 8) {  // ---- producer: one thread issues every load
    if (lane == 0) {
      const size_t srow = (size_t)bh * a.sqp + q0;
      i2i::mbar_arrive_expect_tx(lbar, 2 * TILE * 4);
      i2i::bulk_load(lses, a.lse2 + srow, TILE * 4, lbar);
      i2i::bulk_load(dlts, a.delta + srow, TILE * 4, lbar);
      for (int c = 0; c < CHUNKS; ++c) {
        const int s = c % SC_ST;
        i2i::mbar_wait(&empty[s], ((c / SC_ST) & 1) ^ 1);  // round 0 passes at once
        i2i::mbar_arrive_expect_tx(&full[s], 8 * BOX * 2);
        bf16* st = ring + s * 8 * BOX;
        const int col = col0 + c * 64;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          i2i::tma_load_3d(st + r * BOX, &qmap, &full[s], col, q0 + 64 * r, b);
          i2i::tma_load_3d(st + (2 + r) * BOX, &dmap, &full[s], col, q0 + 64 * r, b);
          i2i::tma_load_3d(st + (4 + r) * BOX, &kmap, &full[s], col, kv0 + 64 * r, b);
          i2i::tma_load_3d(st + (6 + r) * BOX, &vmap, &full[s], col, kv0 + 64 * r, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: its warp w owns Q rows q0 + 64 wg + 16 w
  // .. + 15; register 4j+2hh+e of S and dP is that row + lane/4 + 8 hh,
  // KV column kv0 + 8j + 2t + e
  const int wg = warp >> 2, w = warp & 3, ct = tid & 127, t = lane & 3;
  float sc[64], dp[64];
  int prev = 0;
  for (int c = 0; c < CHUNKS; ++c) {
    const int s = c % SC_ST;
    i2i::mbar_wait(&full[s], (c / SC_ST) & 1);
    const bf16* st = ring + s * 8 * BOX;
    const bf16* qs = st + wg * BOX;
    const bf16* ds = st + (2 + wg) * BOX;
    const bf16* ks = st + 4 * BOX;
    const bf16* vs = st + 6 * BOX;
    i2i::reg_fence(sc);
    i2i::reg_fence(dp);
    i2i::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      i2i::wgmma_m64n128k16_ss(sc, i2i::smem_desc_sw128(qs + kk * 16, 16),
                               i2i::smem_desc_sw128(ks + kk * 16, 16), c > 0 || kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      i2i::wgmma_m64n128k16_ss(dp, i2i::smem_desc_sw128(ds + kk * 16, 16),
                               i2i::smem_desc_sw128(vs + kk * 16, 16), c > 0 || kk > 0);
    i2i::wgmma_commit();
    // keep this chunk's group in flight; the previous one is done, so its
    // stage goes back to the producer
    i2i::wgmma_wait<1>();
    i2i::reg_fence(sc);
    i2i::reg_fence(dp);
    if (c > 0) {
      __syncwarp();
      if (lane == 0) i2i::mbar_arrive(&empty[prev]);
    }
    prev = s;
  }
  i2i::wgmma_wait<0>();
  i2i::reg_fence(sc);
  i2i::reg_fence(dp);

  // ---- P = exp2(S scale log2(e) - lse log2(e)), 0 past Sq and Skv, and
  // dS = P (dP - delta)
  i2i::mbar_wait(lbar, 0);
  float l2[2], dl[2];
  bool rin[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 64 * wg + 16 * w + (lane >> 2) + 8 * hh;
    l2[hh] = lses[r];
    dl[hh] = dlts[r];
    rin[hh] = q0 + r < a.Sq;
  }
  const bool ragged = kv0 + TILE > a.Skv;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * hh + e;
        const float p = exp2f(fmaf(sc[x], a.scale_log2, -l2[hh]));
        const bool in = rin[hh] && !(ragged && kv0 + 8 * j + 2 * t + e >= a.Skv);
        sc[x] = in ? p : 0.f;
        dp[x] = sc[x] * (dp[x] - dl[hh]);
      }

  // ---- both warpgroups are done with the ring: stage P and dS there (32
  // KB a warpgroup) and store both tiles in 16-byte rows
  i2i::named_bar_sync(1, 256);
  unsigned char* stp = smem + wg * 2 * 64 * TILE * 2;
  unsigned char* sts = stp + 64 * TILE * 2;
  stage_tile(sc, 1.f, stp, ct);
  stage_tile(dp, 1.f, sts, ct);
  i2i::named_bar_sync(2 + wg, 128);
  const size_t off = ((size_t)bh * a.band_rows + qr + 64 * wg) * a.skvp + kv0;
  store_rows(stp, a.p + off, a.skvp, 64, ct);
  store_rows(sts, a.ds + off, a.skvp, 64, ct);
}

// One warpgroup's 64 x 128 tile of a product over `nsteps` ring stages: A
// (this warpgroup's box) K-major where TA = 0 (dS for dQ) or MN-major where
// TA = 1 (dS^T for dK, P^T for dV); B MN-major, two 64-column boxes.
template <int TA>
__device__ __forceinline__ void product(float (&acc)[64], const bf16* ring, uint64_t* full,
                                        uint64_t* empty, int nsteps, int wg, int lane) {
  int s = 0, phase = 0, prev = 0;
  for (int i = 0; i < nsteps; ++i) {
    i2i::mbar_wait(&full[s], phase);
    const bf16* as = ring + s * 4 * BOX + wg * BOX;
    const bf16* bs = ring + s * 4 * BOX + 2 * BOX;
    i2i::reg_fence(acc);
    i2i::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < PR_K / 16; ++kc) {
      const uint64_t da = TA ? i2i::smem_desc_sw128(as + kc * 16 * 64, BOX * 2)
                             : i2i::smem_desc_sw128(as + kc * 16, 16);
      i2i::wgmma_m64n128k16_ss_t<TA, 1>(acc, da, i2i::smem_desc_sw128(bs + kc * 16 * 64, BOX * 2),
                                        i > 0 || kc > 0);
    }
    i2i::wgmma_commit();
    i2i::wgmma_wait<1>();
    i2i::reg_fence(acc);
    if (i > 0) {
      __syncwarp();
      if (lane == 0) i2i::mbar_arrive(&empty[prev]);
    }
    prev = s;
    if (++s == PR_ST) {
      s = 0;
      phase ^= 1;
    }
  }
  i2i::wgmma_wait<0>();
  i2i::reg_fence(acc);
}

// Block x: the band's dQ tiles (ntq x 4), then dK's and dV's (nkv x 4 each),
// the 4 column tiles of a row tile next to each other; y: (b, h).
__global__ void __launch_bounds__(THREADS, 1)
products_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap dmap, const __grid_constant__ CUtensorMap pmap,
                const __grid_constant__ CUtensorMap smap, const Args a) {
  using L = PrSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (i2i::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + PR_ST;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int nq = a.ntq * 4, nk = (a.skvp / TILE) * 4;
  int kind = 0, tile = blockIdx.x;  // kind 0 dQ, 1 dK, 2 dV
  if (tile >= nq) {
    tile -= nq;
    kind = 1 + tile / nk;
    tile %= nk;
  }
  const int m = tile >> 2, n = tile & 3;
  const int colb = h * HD + n * TILE;
  const int nsteps = kind == 0 ? a.skvp / PR_K : a.ntq * TILE / PR_K;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < PR_ST; ++s) {
      i2i::mbar_init(&full[s], 1);
      i2i::mbar_init(&empty[s], 8);
    }
    i2i::fence_mbar_init();
  }
  __syncthreads();

  if (warp == 8) {  // ---- producer
    if (lane == 0) {
      const CUtensorMap* am = kind == 2 ? &pmap : &smap;
      const CUtensorMap* bm = kind == 0 ? &kmap : (kind == 1 ? &qmap : &dmap);
      int s = 0, phase = 0;
      for (int i = 0; i < nsteps; ++i) {
        i2i::mbar_wait(&empty[s], phase ^ 1);
        i2i::mbar_arrive_expect_tx(&full[s], 4 * BOX * 2);
        bf16* st = ring + s * 4 * BOX;
        const int k0 = i * PR_K;
        if (kind == 0) {  // A: dS rows m*128 + 64r, KV columns k0; B: K rows k0
          i2i::tma_load_3d(st, am, &full[s], k0, m * TILE, bh);
          i2i::tma_load_3d(st + BOX, am, &full[s], k0, m * TILE + 64, bh);
          i2i::tma_load_3d(st + 2 * BOX, bm, &full[s], colb, k0, b);
          i2i::tma_load_3d(st + 3 * BOX, bm, &full[s], colb + 64, k0, b);
        } else {  // A: dS or P rows k0, KV columns m*128 + 64r; B: Q or dO rows q0 + k0
          i2i::tma_load_3d(st, am, &full[s], m * TILE, k0, bh);
          i2i::tma_load_3d(st + BOX, am, &full[s], m * TILE + 64, k0, bh);
          i2i::tma_load_3d(st + 2 * BOX, bm, &full[s], colb, a.q0 + k0, b);
          i2i::tma_load_3d(st + 3 * BOX, bm, &full[s], colb + 64, a.q0 + k0, b);
        }
        if (++s == PR_ST) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: wg owns rows 64 wg .. + 63 of the tile
  const int wg = warp >> 2, w = warp & 3, ct = tid & 127, t = lane & 3;
  float acc[64];
  if (kind == 0)
    product<0>(acc, ring, full, empty, nsteps, wg, lane);
  else
    product<1>(acc, ring, full, empty, nsteps, wg, lane);

  unsigned char* st = smem + L::out + wg * 64 * TILE * 2;
  if (kind == 0) {  // dQ rows of this band: complete
    const int row0 = a.q0 + m * TILE + 64 * wg;
    stage_tile(acc, a.scale, st, ct);
    i2i::named_bar_sync(1 + wg, 128);
    store_rows(st, a.dq + ((size_t)b * a.Sq + row0) * a.D + colb, a.D, a.Sq - row0, ct);
    return;
  }
  const int row0 = m * TILE + 64 * wg;
  const int limit = a.Skv - row0;
  if (a.bands > 1) {  // add the bands before, in band order; keep the sum unless last
    float* sum = a.acc + (size_t)(kind - 1) * a.B * a.Skv * a.D +
                 ((size_t)b * a.Skv + row0) * a.D + colb;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * w + (lane >> 2) + 8 * hh;
      if (r >= limit) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float2* p2 = reinterpret_cast<float2*>(sum + (size_t)r * a.D + 8 * j + 2 * t);
        if (a.band > 0) {
          const float2 prev = *p2;
          acc[4 * j + 2 * hh] = prev.x + acc[4 * j + 2 * hh];
          acc[4 * j + 2 * hh + 1] = prev.y + acc[4 * j + 2 * hh + 1];
        }
        if (a.band < a.bands - 1) *p2 = make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      }
    }
    if (a.band < a.bands - 1) return;
  }
  stage_tile(acc, kind == 1 ? a.scale : 1.f, st, ct);
  i2i::named_bar_sync(1 + wg, 128);
  store_rows(st, (kind == 1 ? a.dk : a.dv) + ((size_t)b * a.Skv + row0) * a.D + colb, a.D, limit,
             ct);
}

int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
           const float* lse, void* ws, bf16* dq, bf16* dk, bf16* dv, int B, int Sq, int Skv,
           int H, cudaStream_t stream) {
  static thread_local int smem_set_on = -1;  // the device it was last set on
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != smem_set_on) {
    err = cudaFuncSetAttribute(scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ScSmem::bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(products_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 PrSmem::bytes);
    if (err == cudaSuccess) smem_set_on = dev;
  }
  if (err != cudaSuccess) return (int)err;
  const Plan p = plan(B, H, Sq, Skv);
  const int D = H * HD, BH = B * H;
  float* lse2 = static_cast<float*>(ws);
  float* delta = lse2 + (size_t)BH * p.sqp;
  bf16* pw = reinterpret_cast<bf16*>(delta + (size_t)BH * p.sqp);
  bf16* dsw = pw + (size_t)BH * p.band_rows * p.skvp;
  float* acc = reinterpret_cast<float*>(dsw + (size_t)BH * p.band_rows * p.skvp);

  CUtensorMap maps[6];  // q, k, v, dO, P, dS: boxes of 64 rows x 64 columns
  int e = i2i::tensor_map_3d(&maps[0], q, D, Sq, B, 64);
  if (!e) e = i2i::tensor_map_3d(&maps[1], k, D, Skv, B, 64);
  if (!e) e = i2i::tensor_map_3d(&maps[2], v, D, Skv, B, 64);
  if (!e) e = i2i::tensor_map_3d(&maps[3], dout, D, Sq, B, 64);
  if (!e) e = i2i::tensor_map_3d(&maps[4], pw, p.skvp, p.band_rows, BH, 64);
  if (!e) e = i2i::tensor_map_3d(&maps[5], dsw, p.skvp, p.band_rows, BH, 64);
  if (e) return e;

  Args a;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.lse2 = lse2;
  a.delta = delta;
  a.p = pw;
  a.ds = dsw;
  a.acc = acc;
  a.B = B;
  a.H = H;
  a.Sq = Sq;
  a.Skv = Skv;
  a.sqp = p.sqp;
  a.skvp = p.skvp;
  a.D = D;
  a.bands = p.bands;
  a.band_rows = p.band_rows;
  a.scale = 1.0f / sqrtf((float)HD);
  a.scale_log2 = a.scale * LOG2E;

  if ((err = launch_prologue<HD>(o, dout, lse, lse2, delta, B, H, Sq, p.sqp, stream)) !=
      cudaSuccess)
    return (int)err;
  for (int band = 0; band < p.bands; ++band) {
    a.band = band;
    a.q0 = band * p.band_rows;
    a.ntq = band_tiles(p, band);
    scores_kernel<<<dim3(p.nkv, a.ntq, BH), THREADS, ScSmem::bytes, stream>>>(
        maps[0], maps[1], maps[2], maps[3], a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    products_kernel<<<dim3((a.ntq + 2 * p.nkv) * 4, BH), THREADS, PrSmem::bytes, stream>>>(
        maps[0], maps[1], maps[3], maps[4], maps[5], a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace h512

}  // namespace

extern "C" {

// q, o, dout: (B, Sq, H*hd); k, v: (B, Skv, H*hd), all bf16 and 16-byte
// aligned; lse: (B, Sq, H) fp32 from the forward; workspace: scratch of
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
  auto* gq = static_cast<bf16*>(dq);
  auto* gk = static_cast<bf16*>(dk);
  auto* gv = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return h64::launch(qq, kk, vv, oo, gg, ll, static_cast<float*>(workspace), gq, gk, gv, B, Sq,
                       Skv, H, s);
  if (hd == 512)
    return h512::launch(qq, kk, vv, oo, gg, ll, workspace, gq, gk, gv, B, Sq, Skv, H, s);
  return (int)cudaErrorInvalidValue;
}

// The workspace a call needs, in bytes: the relaid lse and delta and, at hd
// 64, for a split Q walk, the partial dK and dV; at hd 512 P and dS of a
// band and, for a banded call, the fp32 sums of dK and dV. 0 for a head dim
// the kernels do not take.
long long flash_attention_bwd_workspace_bytes(int B, int Sq, int Skv, int H, int hd) {
  if (hd == 64) return 4 * (long long)h64::workspace_floats(h64::plan(B, H, Sq, Skv), B, H);
  if (hd == 512) return (long long)h512::workspace_bytes(h512::plan(B, H, Sq, Skv), B, H, Skv);
  return 0;
}

// The launch plan of a call, for run reports, 16 ints. At hd 64: plan[0..2]
// the dq grid, plan[3] its Q rows a block, plan[4] its KV rows a tile,
// plan[5] its ring stages; plan[6..8] the dk/dv grid, plan[9] its KV rows a
// block, plan[10] its Q rows a tile, plan[11] its ring stages; plan[12] the
// splits of the Q walk, plan[13] the Q tiles a split walks; plan[14] the
// kernels a call launches; plan[15] 0. At hd 512: plan[0..2] the scores
// grid of the first band, plan[3] its Q rows a block, plan[4] its KV rows a
// block, plan[5] its ring stages; plan[6..8] the products grid of the first
// band, plan[9] the rows of an output tile, plan[10] the contraction rows a
// step, plan[11] its ring stages; plan[12] the bands of Q rows, plan[13]
// the Q rows a band; plan[14] the kernels a call launches; plan[15] the
// columns of an output tile. Returns 0, or cudaErrorInvalidValue for a head
// dim the kernels do not take.
int flash_attention_bwd_plan(int B, int H, int Sq, int Skv, int hd, int* plan) {
  if (hd == 64) {
    const h64::Plan p = h64::plan(B, H, Sq, Skv);
    const int v[16] = {(int)p.dq_grid.x, (int)p.dq_grid.y, (int)p.dq_grid.z, h64::ROWS,
                       h64::DQ_BKV, h64::DQ_ST, (int)p.dkv_grid.x, (int)p.dkv_grid.y,
                       (int)p.dkv_grid.z, h64::ROWS, h64::ROWS, h64::DKV_ST, p.split, p.tps,
                       p.split > 1 ? 4 : 3, 0};
    for (int i = 0; i < 16; ++i) plan[i] = v[i];
    return 0;
  }
  if (hd == 512) {
    const h512::Plan p = h512::plan(B, H, Sq, Skv);
    const int ntq = h512::band_tiles(p, 0);
    const int v[16] = {p.nkv, ntq, B * H, h512::TILE, h512::TILE, h512::SC_ST,
                       (ntq + 2 * p.nkv) * 4, B * H, 1, h512::TILE, h512::PR_K, h512::PR_ST,
                       p.bands, p.band_rows, 1 + 2 * p.bands, h512::TILE};
    for (int i = 0; i < 16; ++i) plan[i] = v[i];
    return 0;
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
