// Flash attention forward: kernels K2 and K9 of the TPU package, for Hopper
// (sm_90a), one kernel on two layouts.
//
// Replaces img2img_turbo_tpu/ops/attention.py:204 flash_attention_folded
// (K2, body _flash_heads_kernel :151) on folded (B, S, H*hd) tensors, and
// :85 flash_attention (K9, body _flash_kernel :49) on (B, H, S, d) tensors:
// non-causal multi-head attention with an online softmax over KV tiles,
// fp32 running max / running sum / accumulator, P rounded to bf16 before
// the PV product, one rounding of O, masks for ragged Sq and Skv, and on
// request each row's logsumexp (m + log l of the scaled scores, fp32,
// (B, Sq, H)), the residual the backward kernel K7 (attention_bwd.cu)
// rebuilds P from. K9's TPU kernel keeps all of KV resident per (b, h), a
// VMEM choice; here KV streams through shared memory as for K2.
//
// Design. A block owns BQ = 64 query rows of one (batch, head) and DV of
// its head's output columns: one consumer warpgroup and one producer warp. The producer loads the Q tile once, then K and V
// tiles of BKV rows into a ring of ST stages with TMA (one 3-D tensor map
// per operand over (columns, rows, planes): the folded layout's heads are
// column offsets, the (B, H, S, d) layout's are planes, and rows past Sq
// or Skv are zero-filled per plane). Full/empty mbarriers order the ring;
// nothing in the KV loop synchronises the block. Tiles land in shared
// memory with the 128-byte swizzle, as 64-column blocks of 128-byte rows,
// which is the layout wgmma's descriptors read: Q (A) and K (B, K-major)
// for S = Q K^T, V (B, MN-major, transpose bit) for O += P V. Each
// consumer keeps S, the output accumulator and its rows' running max and
// sum in registers: row max and sum go over the thread's values and two
// xor-shuffles inside the quad that shares a row, the scale is folded into
// exp2f with log2(e), and P is converted to bf16 in registers, where the S
// accumulator layout is the A-fragment layout of the register-A wgmma, so P
// never reaches shared memory. Masked columns (kv0 + c >= Skv) are -inf.
// The epilogue divides by the row sum, rounds once and stores bf16 with a
// row mask; lse is written from registers, back in natural log.
//
// hd = 64 (UNet self- and cross-attention): DV = 64, BKV = 128, two ring
// stages. Shared memory: Q 8 KB + 2 x (K 16 KB + V 16 KB) = 72 KB, so two
// blocks share an SM (154 registers a thread). 128-row blocks, two
// consumer warpgroups sharing each K/V tile, measured no faster (PERF.md),
// nor did issuing the next tile's S before this tile's P V (ptxas then
// serialises the wgmmas).
//
// hd = 512 (the VAE mid attention, one head): a 64 x 512 fp32 accumulator
// is 256 registers a thread, more than one warpgroup holds. The output's
// columns are split across blocks instead: each block computes S over the
// full d for its 64 rows and accumulates a DV = 256 column slice (128
// registers a thread), so S costs twice and the flops are 1.5x the least;
// two slices make 128 blocks at S = 4096 (one wave on 132 SMs) where one
// would make 64. Shared memory at BKV = 32: Q 64 KB + 3 stages x (K 32 KB +
// V slice 16 KB) = 208 KB of the 227 KB a block may use. Each slice writes
// its own columns (no combine pass, no atomics: results are deterministic).
//
// What bounds it on the H100: the work is 4 Sq Skv hd flops per head, so
// the long cases are compute-bound (hd = 64, S = 4096: ~22 GFLOP against
// ~5 MB of traffic); the short ones (Skv = 77, S = 64) are launch-bound.

#include <chrono>

#include "hopper.cuh"

using i2i::bf16;

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// One kernel configuration: head dim, output columns a block, KV rows a
// tile, ring stages, blocks an SM.
template <int HD_, int DV_, int BKV_, int ST_, int MINB_>
struct Cfg {
  static constexpr int HD = HD_, DV = DV_, BKV = BKV_, ST = ST_, MINB = MINB_;
  static constexpr int BQ = 64;
  static constexpr int SLICES = HD / DV;  // output column slices a head
  static constexpr int QA = HD / 64, VA = DV / 64;  // 64-column blocks
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int K_BYTES = BKV * HD * 2;
  static constexpr int V_BYTES = BKV * DV * 2;
  static constexpr int q = 0;
  static constexpr int k = q + Q_BYTES;
  static constexpr int v = k + ST * K_BYTES;
  static constexpr int bars = v + ST * V_BYTES;  // q, full[ST], empty[ST]
  static constexpr int smem = bars + 8 * (1 + 2 * ST) + 1024;  // + alignment slack
  static constexpr int threads = 128 + 32;
  static_assert(Q_BYTES % 1024 == 0 && K_BYTES % 1024 == 0 && V_BYTES % 1024 == 0,
                "swizzled tiles must stay 1024-byte aligned");
  // a block for each BQ query rows of one (batch, head) and column slice
  static dim3 grid(int B, int H, int Sq) { return dim3((Sq + BQ - 1) / BQ * SLICES, H, B); }
};

// Element strides of a (batch, head, row) walk of o; a row's hd values are
// contiguous.
struct Strides {
  long long b, h, s;
};

struct Args {
  bf16* o;
  float* lse;  // (B, Sq, H) or null
  Strides os;
  int Sq, Skv, H, folded;
  float scale_log2;  // 1/sqrt(hd) * log2(e)
};

template <class C>
__global__ void __launch_bounds__(C::threads, C::MINB)
flash_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, const Args a) {
  constexpr int HD = C::HD, DV = C::DV, BKV = C::BKV, ST = C::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (i2i::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(smem + C::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + C::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + C::v);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + C::bars);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slice = blockIdx.x % C::SLICES;
  const int q0 = (blockIdx.x / C::SLICES) * C::BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int plane = a.folded ? b : b * a.H + h;
  const int col0 = a.folded ? h * HD : 0;
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
      i2i::mbar_arrive_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::QA; ++c)
        i2i::tma_load_3d(Qs + c * C::BQ * 64, &qmap, qbar, col0 + c * 64, q0, plane);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % ST;
        i2i::mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);  // round 0 passes at once
        i2i::mbar_arrive_expect_tx(&full[s], C::K_BYTES + C::V_BYTES);
#pragma unroll
        for (int c = 0; c < C::QA; ++c)
          i2i::tma_load_3d(Ks + s * BKV * HD + c * BKV * 64, &kmap, &full[s], col0 + c * 64,
                           i * BKV, plane);
#pragma unroll
        for (int c = 0; c < C::VA; ++c)
          i2i::tma_load_3d(Vs + s * BKV * DV + c * BKV * 64, &vmap, &full[s],
                           col0 + slice * DV + c * 64, i * BKV, plane);
      }
    }
    return;
  }

  // ---- consumer warpgroup: warp wq owns rows q0 + 16 wq .. + 15
  const int wq = warp, t = lane & 3;
  float o[DV / 2];
#pragma unroll
  for (int r = 0; r < DV / 2; ++r) o[r] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max (base 2, scaled)
  float l[2] = {0.f, 0.f};              // this thread's share of the row sum

  i2i::mbar_wait(qbar, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % ST;
    i2i::mbar_wait(&full[s], (i / ST) & 1);
    const bf16* ks = Ks + s * BKV * HD;
    const bf16* vs = Vs + s * BKV * DV;

    // S = Q K^T over hd, in 64-column blocks of k16 steps
    float sc[BKV / 2];
#pragma unroll
    for (int r = 0; r < BKV / 2; ++r) sc[r] = 0.f;
    i2i::wgmma_fence();
#pragma unroll
    for (int c = 0; c < C::QA; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = i2i::smem_desc_sw128(Qs + c * C::BQ * 64 + kk * 16, 16);
        const uint64_t db = i2i::smem_desc_sw128(ks + c * BKV * 64 + kk * 16, 16);
        if constexpr (BKV == 128)
          i2i::wgmma_m64n128k16_ss(sc, da, db, c + kk > 0);
        else
          i2i::wgmma_m64n32k16_ss(sc, da, db, c + kk > 0);
      }
    }
    i2i::wgmma_commit();
    i2i::wgmma_wait<0>();
    i2i::reg_fence(sc);

    // online softmax on the accumulator fragment: register 4j+2hh+e is row
    // 16 wq + lane/4 + 8 hh, column 8j + 2t + e of the tile
    const int kv0 = i * BKV;
    if (kv0 + BKV > a.Skv) {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (kv0 + 8 * j + 2 * t + e >= a.Skv) sc[4 * j + e] = sc[4 * j + 2 + e] = -INFINITY;
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[hh], mx * a.scale_log2);
      alpha[hh] = exp2f(m[hh] - mn);
      m[hh] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(sc[4 * j + 2 * hh + e], a.scale_log2, -mn));
          sc[4 * j + 2 * hh + e] = p;
          sum += p;
        }
      l[hh] = l[hh] * alpha[hh] + sum;
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        o[4 * j + 2 * hh] *= alpha[hh];
        o[4 * j + 2 * hh + 1] *= alpha[hh];
      }

    // P (bf16) as the register A operand: the k16 chunk kc of the tile is
    // accumulator registers 8kc .. 8kc+7, pairwise
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const __nv_bfloat162 p2 = __floats2bfloat162_rn(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);
        pa[kc][r] = *reinterpret_cast<const uint32_t*>(&p2);
      }

    // O += P V; V is MN-major, its 64-column blocks BKV * 128 bytes apart
    i2i::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      const uint64_t db = i2i::smem_desc_sw128(vs + kc * 16 * 64, BKV * 128);
      if constexpr (DV == 64)
        i2i::wgmma_m64n64k16_rs_tb(o, pa[kc], db);
      else
        i2i::wgmma_m64n256k16_rs_tb(o, pa[kc], db);
    }
    i2i::wgmma_commit();
    i2i::wgmma_wait<0>();
    i2i::reg_fence(o);
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) i2i::reg_fence(pa[kc]);
    __syncwarp();
    if (lane == 0) i2i::mbar_arrive(&empty[s]);  // this warp is done with stage s
  }

  // ---- epilogue: O / l, one rounding, rows past Sq not stored
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int row = q0 + wq * 16 + (lane >> 2) + 8 * hh;
    if (row >= a.Sq) continue;
    bf16* orow = a.o + (size_t)(b * a.os.b + h * a.os.h + row * a.os.s) + slice * DV + 2 * t;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * hh] / l[hh], o[4 * j + 2 * hh + 1] / l[hh]);
    if (a.lse != nullptr && slice == 0 && t == 0)
      a.lse[((size_t)b * a.Sq + row) * a.H + h] = (m[hh] + log2f(l[hh])) * LN2;
  }
}

// What a call does on the host before it enqueues the kernel: the kernel's
// shared-memory limit, set once per device and host thread (a driver call),
// and the three tensor maps. folded (B, S, H*hd): head h is columns
// [h*hd, (h+1)*hd) of each row of plane b; (B, H, S, d): head h of batch b
// is plane b*H + h.
template <class C>
int setup(const void* q, const void* k, const void* v, int B, int Sq, int Skv, int H, bool folded,
          CUtensorMap maps[3]) {
  static thread_local int smem_set_on = -1;  // the device it was last set on
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != smem_set_on) {
    err = cudaFuncSetAttribute(flash_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::smem);
    if (err == cudaSuccess) smem_set_on = dev;
  }
  if (err != cudaSuccess) return (int)err;
  const int cols = folded ? H * C::HD : C::HD, planes = folded ? B : B * H;
  int e = i2i::tensor_map_3d(&maps[0], q, cols, Sq, planes, C::BQ);
  if (!e) e = i2i::tensor_map_3d(&maps[1], k, cols, Skv, planes, C::BKV);
  if (!e) e = i2i::tensor_map_3d(&maps[2], v, cols, Skv, planes, C::BKV);
  return e;
}

template <class C>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Sq,
           int Skv, int H, bool folded, cudaStream_t stream) {
  CUtensorMap maps[3];
  const int e = setup<C>(q, k, v, B, Sq, Skv, H, folded, maps);
  if (e) return e;
  constexpr int HD = C::HD;
  const long long D = folded ? (long long)H * HD : HD;
  Args a;
  a.o = static_cast<bf16*>(o);
  a.lse = static_cast<float*>(lse);
  a.os = folded ? Strides{Sq * D, HD, D} : Strides{(long long)H * Sq * HD, (long long)Sq * HD, HD};
  a.Sq = Sq;
  a.Skv = Skv;
  a.H = H;
  a.folded = folded;
  a.scale_log2 = LOG2E / sqrtf((float)HD);
  flash_kernel<C><<<C::grid(B, H, Sq), C::threads, C::smem, stream>>>(maps[0], maps[1], maps[2],
                                                                      a);
  return (int)cudaGetLastError();
}

// The configuration of a call by head dim, handed to f as a value of its
// type: hd = 64 two blocks an SM; hd = 512 two 256-column slices, one block
// an SM. Every entry point dispatches through here.
template <class F>
int with_cfg(int hd, F&& f) {
  if (hd == 64) return f(Cfg<64, 64, 128, 2, 2>{});
  if (hd == 512) return f(Cfg<512, 256, 32, 3, 1>{});
  return (int)cudaErrorInvalidValue;
}

int run(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Sq, int Skv,
        int H, int hd, bool folded, void* stream) {
  return with_cfg(hd, [&](auto c) {
    return launch<decltype(c)>(q, k, v, o, lse, B, Sq, Skv, H, folded,
                               static_cast<cudaStream_t>(stream));
  });
}

}  // namespace

extern "C" {

// q: (B, Sq, H*hd), k/v: (B, Skv, H*hd), o: (B, Sq, H*hd), all bf16 and
// 16-byte aligned; lse: (B, Sq, H) fp32 or null. hd must be 64 or 512.
// Returns cudaGetLastError(), or TENSOR_MAP_ERROR + the CUresult of a
// refused tensor map.
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                         int Sq, int Skv, int H, int hd, void* stream) {
  return run(q, k, v, o, lse, B, Sq, Skv, H, hd, true, stream);
}

// K9. q, o: (B, H, Sq, 64), k/v: (B, H, Skv, 64), all bf16 and contiguous.
// Returns as flash_attention_bf16.
int flash_attention_bhsd_bf16(const void* q, const void* k, const void* v, void* o, int B,
                              int H, int Sq, int Skv, void* stream) {
  return run(q, k, v, o, nullptr, B, Sq, Skv, H, 64, false, stream);
}

// The launch plan of a call, for run reports: plan[0..2] the grid, plan[3]
// the query rows of a block, plan[4] the output column slices of a head.
// Returns 0, or cudaErrorInvalidValue for a head dim the kernel does not
// take.
int flash_attention_plan(int B, int H, int Sq, int hd, int* plan) {
  return with_cfg(hd, [&](auto c) {
    using C = decltype(c);
    const dim3 g = C::grid(B, H, Sq);
    const int p[5] = {(int)g.x, (int)g.y, (int)g.z, C::BQ, C::SLICES};
    for (int i = 0; i < 5; ++i) plan[i] = p[i];
    return 0;
  });
}

// The host time of a folded call's set-up (`setup`: the shared-memory limit
// and the three tensor-map encodes), in ns, averaged over `iters` set-ups,
// for run reports; its error, negated, if one failed.
double flash_attention_setup_ns(const void* q, const void* k, const void* v, int B, int Sq,
                                int Skv, int H, int hd, int iters) {
  double ns = 0.0;
  const int e = with_cfg(hd, [&](auto c) {
    CUtensorMap maps[3];
    const auto t0 = std::chrono::steady_clock::now();
    for (int i = 0; i < iters; ++i) {
      const int err = setup<decltype(c)>(q, k, v, B, Sq, Skv, H, true, maps);
      if (err) return err;
    }
    ns = std::chrono::duration<double, std::nano>(std::chrono::steady_clock::now() - t0).count();
    return 0;
  });
  return e ? -(double)e : ns / iters;
}

}  // extern "C"
