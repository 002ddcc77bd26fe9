// LayerNorm + matmul engine: kernel K3 of the TPU package, for Hopper
// (sm_90a), on the warpgroup tensor-core instruction (wgmma) fed by TMA.
//
// Replaces img2img_turbo_tpu/ops/fused_matmul.py:223 _pallas (body _kernel
// :186, entry fused :321): an optional LayerNorm (fp32 two-pass row
// statistics, fp32 affine, rounded to bf16 before the product) feeding 1-3
// matmuls that share it, a per-output fp32 bias, an optional residual added
// AFTER the cast to bf16 (fused_matmul.py:216-220), and a gate mode
// (xn@wv+bv) * gelu_erf(xn@wg+bg) on diffusers' packed GEGLU weight, value
// half first.
//
// Design. Weights are nn.Linear's (Co, C) bf16 ((2Co, C) in gate mode,
// value rows first): the K-major B operand, which TMA writes with the
// 128-byte swizzle and the SW128 descriptors read, as the K tile of
// S = Q K^T in attention.cu. A block runs one consumer warpgroup per 64 of
// its BM rows and one producer warp, and owns BN-column tiles of one output
// (grid.z picks the output of the 2- and 3-output modes). The producer
// streams weight tiles (BN rows x 64 channels; in gate mode also the gate
// rows Co + n0) into a ring of ST stages with TMA, ordered by full/empty
// mbarriers; rows past M and channels past C are zero-filled. Each
// consumer keeps its 64 x BN fp32 accumulator in registers (two in gate
// mode: value and gate) and one wgmma group in flight while the next stage
// is waited for. x reaches the wgmma in one of two ways:
//
// - plain calls (no LayerNorm, no gate) stream x tiles (BM x 64) through
//   the ring beside the weight tiles, one output tile a block;
// - LayerNorm and gate calls keep the block's 64 x C rows of x resident as
//   a panel (C/64 swizzled tiles, one TMA barrier). The consumer computes
//   each row's mean and rstd in fp32, two passes over the panel in shared
//   memory, then normalises the panel in place ((x - mean) * rstd * s + b
//   in fp32, one rounding to bf16), fences the async proxy and syncs on a
//   named barrier; the block then walks several output tiles over the same
//   panel, so the statistics and the normalisation are paid once per
//   block, not once per tile. LN is not folded into the weights (that
//   rounds differently from the JAX kernel and cancels badly when a row's
//   mean is large).
//
// The epilogue works on the accumulator registers: bias, the gate, one
// rounding to bf16, then the residual added in bf16 (rounded once more, as
// JAX adds two bf16 arrays); rows past M and columns past Co are masked.
// The launch plan lives in plan() below, its only copy.
//
// What bounds it on the H100: the product does M flops per weight byte, so
// the M >= 1024 cases are compute-bound (the card's balance is ~295 flops
// a byte) and the deep levels (M = 256, 64) and the 77-row context K/V are
// bound by streaming the weights, which the plan spreads over as many
// blocks as it can without splitting K.

#include <algorithm>

#include "hopper.cuh"

using i2i::bf16;
using i2i::Pack8;

namespace {

constexpr int BK = 64;           // channels a stage: one 128-byte swizzled row
constexpr int ST = 4;            // ring stages
constexpr int NUM_SMS = 132;
constexpr int MAX_SMEM = 232448;  // the shared memory a block may use

// One kernel configuration: rows and output columns a block, the gate
// mode, and where x lives: streamed through the ring beside the weight
// tiles, or (PANEL) loaded once as the block's resident BM x C panel,
// which the LayerNorm normalises in place.
template <int BM_, int BN_, bool GATE_, bool PANEL_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr bool GATE = GATE_, PANEL = PANEL_;
  static constexpr int NC = BM / 64;        // consumer warpgroups
  static constexpr int NB = GATE ? 2 : 1;   // weight tiles a stage
  static constexpr int X_BYTES = BM * BK * 2;  // an x tile: 64 channels of BM rows
  static constexpr int W_BYTES = BN * BK * 2;
  static constexpr int STAGE = (PANEL ? 0 : X_BYTES) + NB * W_BYTES;
  // layout: full[ST], empty[ST] and the panel's barrier, then the ring,
  // then the panel
  static constexpr int ring = 1024;
  static constexpr int panel = ring + ST * STAGE;
  static constexpr int threads = NC * 128 + 32;
  static_assert(X_BYTES % 1024 == 0 && W_BYTES % 1024 == 0,
                "swizzled tiles must stay 1024-byte aligned");
  // dynamic shared memory of a call with C channels (+ alignment slack)
  static int smem(int C) { return panel + (PANEL ? (C + BK - 1) / BK * X_BYTES : 0) + 1024; }
};

struct Args {
  const float* ln_s;      // (C) or null
  const float* ln_b;      // (C)
  const float* bias[3];   // (Co) each; gate mode: packed (2Co)
  const bf16* res;        // (M, Co) or null
  bf16* y[3];             // (M, Co) each
  int M, C, Co;
  int nt, tpc;            // BN-column tiles of an output; tiles a block
  float eps;
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

template <int BN>
__device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 128)
    i2i::wgmma_m64n128k16_ss(d, da, db, scale_d);
  else
    i2i::wgmma_m64n64k16_ss(d, da, db, scale_d);
}

template <class Cf>
__global__ void __launch_bounds__(Cf::threads, 1)
mm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap0,
          const __grid_constant__ CUtensorMap wmap1, const __grid_constant__ CUtensorMap wmap2,
          const Args a) {
  constexpr int BM = Cf::BM, BN = Cf::BN, NB = Cf::NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (i2i::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + ST;
  uint64_t* pbar = empty + ST;
  unsigned char* ring = smem + Cf::ring;
  bf16* panel = reinterpret_cast<bf16*>(smem + Cf::panel);
  // named barrier of the warpgroup (a constant id when there is one)
  const int wg_bar = 1 + (Cf::NC > 1 ? (int)(threadIdx.x >> 7) : 0);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM, z = blockIdx.z;
  const int KT = (a.C + BK - 1) / BK;
  // this block's output-column tiles [t0, t1)
  const int t0 = blockIdx.y * a.tpc, t1 = min(t0 + a.tpc, a.nt);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      i2i::mbar_init(&full[s], 1);
      i2i::mbar_init(&empty[s], 4 * Cf::NC);  // one arrival per consumer warp
    }
    i2i::mbar_init(pbar, 1);
    i2i::fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4 * Cf::NC) {  // ---- producer: one thread issues every load
    if (lane == 0) {
      const CUtensorMap* wm = z == 0 ? &wmap0 : (z == 1 ? &wmap1 : &wmap2);
      if constexpr (Cf::PANEL) {
        i2i::mbar_arrive_expect_tx(pbar, KT * Cf::X_BYTES);
        for (int kt = 0; kt < KT; ++kt)
          i2i::tma_load_2d(panel + kt * BM * BK, &xmap, pbar, kt * BK, m0);
      }
      int s = 0, phase = 0;  // ring stage and its round's parity
      for (int t = t0; t < t1; ++t) {
        for (int kt = 0; kt < KT; ++kt) {
          i2i::mbar_wait(&empty[s], phase ^ 1);  // round 0 passes at once
          i2i::mbar_arrive_expect_tx(&full[s], Cf::STAGE);
          bf16* st = reinterpret_cast<bf16*>(ring + s * Cf::STAGE);
          if constexpr (!Cf::PANEL) {
            i2i::tma_load_2d(st, &xmap, &full[s], kt * BK, m0);
            st += BM * BK;
          }
          i2i::tma_load_2d(st, wm, &full[s], kt * BK, t * BN);
          if constexpr (Cf::GATE)
            i2i::tma_load_2d(st + BN * BK, wm, &full[s], kt * BK, a.Co + t * BN);
          if (++s == ST) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: rows wg*64 .. +63 of the block; warp wq of
  // it owns rows 16 wq .. +15 of those
  const int wg = warp >> 2, wq = warp & 3;
  if constexpr (Cf::PANEL) {
    i2i::mbar_wait(pbar, 0);
    if (a.ln_s != nullptr) {
      // Warp wq normalises its 16 rows, 4 at a time, each row shared by 8
      // lanes: lane l takes the 16-byte chunk l % 8 of each of the row's
      // 64-channel blocks (128-byte rows whose chunk pc holds channels
      // 8 (pc ^ (row % 8)) ..). Two fp32 passes give the mean and the
      // variance (the row's 8 lanes summed by shuffles), kept in registers;
      // a third writes (x - mean) * rstd * s + b, rounded once to bf16, in
      // place. The 4 rows are independent chains.
      const int ch = lane & 7;
      int r[4], lc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        r[i] = wg * 64 + wq * 16 + 4 * i + (lane >> 3);
        lc[i] = ch ^ (r[i] & 7);
      }
      auto chunk = [&](int i, int cb) {
        return reinterpret_cast<Pack8*>(panel + cb * BM * BK + r[i] * BK + ch * 8);
      };
      auto row_sum = [&](float v) {
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        return v + __shfl_xor_sync(0xffffffffu, v, 4);
      };
      // Each pass takes two 64-channel blocks at a time, all their loads
      // first (the third pass stores in place, so later loads cannot be
      // hoisted above its stores by the compiler).
      auto tree = [](const float (&f)[8]) {
        return ((f[0] + f[1]) + (f[2] + f[3])) + ((f[4] + f[5]) + (f[6] + f[7]));
      };
      float mean[4], rstd[4], acc4[4] = {0.f, 0.f, 0.f, 0.f};
      for (int cb = 0; cb < KT; cb += 2) {
        Pack8 v[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int i = 0; i < 4; ++i) v[u][i] = cb + u < KT ? *chunk(i, cb + u) : i2i::zero8();
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float f[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(v[u][i].h[e]);
            acc4[i] += tree(f);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mean[i] = row_sum(acc4[i]) / a.C;
        acc4[i] = 0.f;
      }
      for (int cb = 0; cb < KT; cb += 2) {
        Pack8 v[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int i = 0; i < 4; ++i) v[u][i] = cb + u < KT ? *chunk(i, cb + u) : i2i::zero8();
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // zero-filled channels past C do not count
            const float in = (cb + u) * BK + 8 * lc[i] < a.C ? 1.f : 0.f;
            float f[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float d = (__bfloat162float(v[u][i].h[e]) - mean[i]) * in;
              f[e] = d * d;
            }
            acc4[i] += tree(f);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) rstd[i] = rsqrtf(row_sum(acc4[i]) / a.C + a.eps);
      // rows i and i + 2 share their channels (lc[i] == lc[i + 2])
      for (int cb = 0; cb < KT; cb += 2) {
        Pack8 v[2][4];
        float4 sc[2][2][2], sh[2][2][2];  // [u][lc pair][half]
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[u][i] = cb + u < KT ? *chunk(i, cb + u) : i2i::zero8();
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int c = min((cb + u) * BK + 8 * lc[k], a.C - 8);  // clamped: masked below
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              sc[u][k][hf] = __ldg(reinterpret_cast<const float4*>(a.ln_s + c + 4 * hf));
              sh[u][k][hf] = __ldg(reinterpret_cast<const float4*>(a.ln_b + c + 4 * hf));
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (cb + u >= KT) break;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool in = (cb + u) * BK + 8 * lc[i] < a.C;
            const float4* s4 = sc[u][i & 1];
            const float4* b4 = sh[u][i & 1];
            const float scl[8] = {s4[0].x, s4[0].y, s4[0].z, s4[0].w,
                                  s4[1].x, s4[1].y, s4[1].z, s4[1].w};
            const float shf[8] = {b4[0].x, b4[0].y, b4[0].z, b4[0].w,
                                  b4[1].x, b4[1].y, b4[1].z, b4[1].w};
            Pack8 o;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float t = (__bfloat162float(v[u][i].h[e]) - mean[i]) * rstd[i];
              o.h[e] = __float2bfloat16(in ? t * scl[e] + shf[e] : 0.f);
            }
            *chunk(i, cb + u) = o;
          }
        }
      }
      i2i::fence_proxy_async();  // the wgmmas read what the threads wrote
      i2i::named_bar_sync(wg_bar, 128);
    }
  }

  // The accumulators are not zeroed by other instructions: each tile's
  // first wgmma overwrites them (scale_d = 0), so ptxas can keep a group in
  // flight across the loop without serialising the wgmmas.
  float acc[BN / 2];
  float accg[Cf::GATE ? BN / 2 : 1];
  const float* bias = z == 0 ? a.bias[0] : (z == 1 ? a.bias[1] : a.bias[2]);
  bf16* y = z == 0 ? a.y[0] : (z == 1 ? a.y[1] : a.y[2]);
  int s = 0, phase = 0, prev = 0;  // ring stage, its parity, the one before
  const int row0 = m0 + wg * 64 + wq * 16 + (lane >> 2);  // + 8h
  for (int t = t0; t < t1; ++t) {
    // the tile's bias (and gate bias, residual) fetched before its product,
    // so that the epilogue does not wait on them: columns 8j + 2(lane%4)
    float2 bv[BN / 8], bgv[Cf::GATE ? BN / 8 : 1];
    __nv_bfloat162 rv[2][BN / 8];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = t * BN + 8 * j + 2 * (lane & 3);
      const bool in = n < a.Co;
      bv[j] = in ? *reinterpret_cast<const float2*>(bias + n) : make_float2(0.f, 0.f);
      if constexpr (Cf::GATE)
        bgv[j] = in ? *reinterpret_cast<const float2*>(bias + a.Co + n) : make_float2(0.f, 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row0 + 8 * h;
        rv[h][j] = a.res != nullptr && in && m < a.M
                       ? *reinterpret_cast<const __nv_bfloat162*>(a.res + (size_t)m * a.Co + n)
                       : __floats2bfloat162_rn(0.f, 0.f);
      }
    }
    for (int kt = 0; kt < KT; ++kt) {
      i2i::mbar_wait(&full[s], phase);
      const bf16* st = reinterpret_cast<const bf16*>(ring + s * Cf::STAGE);
      const bf16* xt = (Cf::PANEL ? panel + kt * BM * BK : st) + wg * 64 * BK;
      const bf16* wt = Cf::PANEL ? st : st + BM * BK;
      i2i::reg_fence(acc);
      i2i::reg_fence(accg);
      i2i::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = i2i::smem_desc_sw128(xt + kk * 16, 16);
        const int scale_d = kt > 0 || kk > 0;
        mma<BN>(acc, da, i2i::smem_desc_sw128(wt + kk * 16, 16), scale_d);
        if constexpr (Cf::GATE)
          mma<BN>(accg, da, i2i::smem_desc_sw128(wt + BN * BK + kk * 16, 16), scale_d);
      }
      i2i::wgmma_commit();
      // keep this stage's group in flight; the previous one is done, so
      // its stage goes back to the producer
      i2i::wgmma_wait<1>();
      i2i::reg_fence(acc);
      i2i::reg_fence(accg);
      if (kt > 0) {
        __syncwarp();
        if (lane == 0) i2i::mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == ST) {
        s = 0;
        phase ^= 1;
      }
    }
    i2i::wgmma_wait<0>();
    i2i::reg_fence(acc);
    i2i::reg_fence(accg);
    __syncwarp();
    if (lane == 0) i2i::mbar_arrive(&empty[prev]);  // the tile's last stage

    // ---- epilogue: register 4j+2h+e is row 16 wq + lane/4 + 8h, column
    // 8j + 2(lane%4) + e of the warpgroup's 64 x BN tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + 8 * h;
      if (m >= a.M) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = t * BN + 8 * j + 2 * (lane & 3);
        if (n >= a.Co) continue;
        float v0 = acc[4 * j + 2 * h] + bv[j].x, v1 = acc[4 * j + 2 * h + 1] + bv[j].y;
        if constexpr (Cf::GATE) {
          v0 *= gelu_erf(accg[4 * j + 2 * h] + bgv[j].x);
          v1 *= gelu_erf(accg[4 * j + 2 * h + 1] + bgv[j].y);
        }
        __nv_bfloat162 yb = __floats2bfloat162_rn(v0, v1);
        if (a.res != nullptr)
          yb = __floats2bfloat162_rn(__bfloat162float(yb.x) + __bfloat162float(rv[h][j].x),
                                     __bfloat162float(yb.y) + __bfloat162float(rv[h][j].y));
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * a.Co + n) = yb;
      }
    }
  }
}

// A bf16 (rows, cols) matrix as boxes of 64 columns x box_rows rows,
// 128-byte swizzled, zero-filled outside.
int encode(CUtensorMap* map, const void* base, int cols, int rows, int box_rows) {
  static const i2i::EncodeFn fn = i2i::tensor_map_encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {BK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : i2i::TENSOR_MAP_ERROR + (int)r;
}

// The launch plan. Calls with a LayerNorm or a gate take the panel
// kernel: BM = BN = 64, and each block walks tpc of an output's 64-column
// tiles over its resident panel, tpc chosen so that the grid fills one wave
// of the 132 SMs with as few tiles as possible (each block loads and
// normalises its panel once). Plain calls stream x: BN = 128 when Co is a
// multiple of 128, else 64; BM = 128 when that makes a full wave of blocks,
// else BM = 64 and, if still under a wave, BN = 64.
struct Plan {
  bool panel;
  int bm, bn, nt, tpc;
  dim3 grid;
};

Plan plan(int M, int Co, int n_out, bool ln, bool gate) {
  Plan p;
  p.panel = ln || gate;
  if (p.panel) {
    p.bm = p.bn = 64;
    p.nt = (Co + 63) / 64;
    const int mt = (M + 63) / 64;
    const int chunks = std::min(p.nt, (NUM_SMS + mt * n_out - 1) / (mt * n_out));
    p.tpc = (p.nt + chunks - 1) / chunks;
    p.grid = dim3(mt, (p.nt + p.tpc - 1) / p.tpc, n_out);
    return p;
  }
  auto blocks = [&](int bm, int bn) {
    return (long)((M + bm - 1) / bm) * ((Co + bn - 1) / bn) * n_out;
  };
  p.bn = Co % 128 == 0 ? 128 : 64;
  p.bm = blocks(128, p.bn) >= NUM_SMS ? 128 : 64;
  if (p.bm == 64 && p.bn == 128 && blocks(64, 128) < NUM_SMS) p.bn = 64;
  p.nt = (Co + p.bn - 1) / p.bn;
  p.tpc = 1;
  p.grid = dim3((M + p.bm - 1) / p.bm, p.nt, n_out);
  return p;
}

template <class Cf>
int launch(const void* x, const void* const w[3], Args a, int n_out, const Plan& p,
           cudaStream_t stream) {
  const int smem = Cf::smem(a.C);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;  // a panel too wide
  static thread_local int smem_set_on = -1;  // the device it was last set on
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != smem_set_on) {
    err = cudaFuncSetAttribute(mm_kernel<Cf>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err == cudaSuccess) smem_set_on = dev;
  }
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[4];
  int e = encode(&maps[0], x, a.C, a.M, Cf::BM);
  const int wrows = Cf::GATE ? 2 * a.Co : a.Co;
  for (int i = 0; i < 3 && !e; ++i)  // unused outputs repeat the first map
    e = encode(&maps[1 + i], w[i < n_out ? i : 0], a.C, wrows, Cf::BN);
  if (e) return e;
  a.nt = p.nt;
  a.tpc = p.tpc;
  mm_kernel<Cf><<<p.grid, Cf::threads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], a);
  return (int)cudaGetLastError();
}

// The kernel configuration of a plan, handed to f as a value of its type.
template <class F>
int with_cfg(const Plan& p, bool gate, F&& f) {
  if (p.panel) return gate ? f(Cfg<64, 64, true, true>{}) : f(Cfg<64, 64, false, true>{});
  if (p.bm == 128)
    return p.bn == 128 ? f(Cfg<128, 128, false, false>{}) : f(Cfg<128, 64, false, false>{});
  return p.bn == 128 ? f(Cfg<64, 128, false, false>{}) : f(Cfg<64, 64, false, false>{});
}

}  // namespace

extern "C" {

// x (M, C) bf16; ln_s/ln_b fp32 (C) or null; w0..w2 bf16 (Co, C); b0..b2
// fp32 (Co); res bf16 (M, Co) or null (one output only); y0..y2 bf16
// (M, Co). gate = 1: w0 is the packed (2Co, C) GEGLU weight (value rows
// first) and b0 the packed (2Co) bias; one output. Pointers 16-byte
// aligned, C and Co multiples of 8; with a LayerNorm or the gate, the
// normalised 64 x C panel must fit in shared memory beside the weight ring
// (C <= 1280 with the gate, 1536 without). Returns cudaGetLastError(),
// cudaErrorInvalidValue for what the kernel does not take, or
// TENSOR_MAP_ERROR + the CUresult of a refused tensor map.
int fused_matmul_bf16(const void* x, const void* ln_s, const void* ln_b, const void* w0,
                      const void* w1, const void* w2, const void* b0, const void* b1,
                      const void* b2, const void* res, void* y0, void* y1, void* y2, int M,
                      int C, int Co, int n_out, int gate, float eps, void* stream) {
  if (M < 1 || C % 8 || Co % 8 || n_out < 1 || n_out > 3 || (gate && n_out != 1))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.ln_s = static_cast<const float*>(ln_s);
  a.ln_b = static_cast<const float*>(ln_b);
  a.bias[0] = static_cast<const float*>(b0);
  a.bias[1] = static_cast<const float*>(b1);
  a.bias[2] = static_cast<const float*>(b2);
  a.res = static_cast<const bf16*>(res);
  a.y[0] = static_cast<bf16*>(y0);
  a.y[1] = static_cast<bf16*>(y1);
  a.y[2] = static_cast<bf16*>(y2);
  a.M = M; a.C = C; a.Co = Co; a.eps = eps;
  const void* const w[3] = {w0, w1, w2};
  const Plan p = plan(M, Co, n_out, ln_s != nullptr, gate);
  return with_cfg(p, gate, [&](auto c) {
    return launch<decltype(c)>(x, w, a, n_out, p, static_cast<cudaStream_t>(stream));
  });
}

// The launch plan of a call, for run reports: plan[0..2] the grid,
// plan[3] the rows and plan[4] the output columns of a tile, plan[5] the
// tiles a block walks, plan[6] 1 for the panel kernel. Returns 0.
int fused_matmul_plan(int M, int Co, int n_out, int ln, int gate, int* plan_out) {
  const Plan p = plan(M, Co, n_out, ln, gate);
  const int v[7] = {(int)p.grid.x, (int)p.grid.y, (int)p.grid.z, p.bm, p.bn, p.tpc, p.panel};
  for (int i = 0; i < 7; ++i) plan_out[i] = v[i];
  return 0;
}

}  // extern "C"
