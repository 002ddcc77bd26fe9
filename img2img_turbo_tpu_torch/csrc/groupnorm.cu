// GroupNorm statistics, kernel K5 of the TPU package, and the combine that
// folds them into the GroupNorm affine, for Hopper (sm_90a).
//
// Replaces img2img_turbo_tpu/ops/groupnorm.py:54 group_norm_coeffs (its
// pallas_call at :81, body _partial_stats_kernel :45) and the XLA
// img2img_turbo_tpu/ops/fused_conv.py:1782 combine_stats:
//   partial_stats: per-tile, per-channel fp32 sum and sum of squares of a
//        (B, S, C) activation, written as (B, n_tiles, 2, C); a tile is
//        TILE_ROWS = 256 rows, so the VAE's 262,144 elements a channel at
//        512^2 are summed as 1,024 partials of 256 and never as one long
//        serial fp32 sum. A block takes a tile of 64 channels from 16-byte
//        loads (8 bf16 or 4 fp32 channels a load), rows past S masked; its
//        threads sum strided rows, then one thread a channel adds the row
//        groups in order;
//   combine: one block per (b, group) sums the group's partials (of this
//        kernel or emitted by the conv kernels K1 and K6) in a fixed
//        order, mean = s1 / n, var = max(s2 / n - mean^2, 0), and writes
//        the folded affine a = scale * rsqrt(var + eps) and b = bias -
//        mean * a, each (B, C) fp32, so that GN(x) * scale + bias = x a + b.
// Nothing is atomic: a repeated call is bit-identical. group_norm_coeffs
// launches both in one host call; the point of this file is host time a
// GroupNorm (the combine was ~9 PyTorch kernels).
//
// What bounds it on the H100: bytes. partial_stats reads x once (a VAE
// 256^2 x 256 activation, 32 MiB, takes ~10 us at 3.35 TB/s); the combine
// reads the partials (at most a few MiB) and is bound by its launch.

#include "common.cuh"

using i2i::bf16;

namespace {

constexpr int TILE_ROWS = 256;
constexpr int BC = 64;          // channels a partial_stats block
constexpr int THREADS = 256;

// Block (tile, 64-channel chunk, b). VEC channels a 16-byte load; NV loads
// span the chunk's row; RG row groups, each thread summing rows rg, rg +
// RG, ... of the tile.
template <typename T>
__global__ void __launch_bounds__(THREADS)
partial_stats_kernel(const T* __restrict__ x, float* __restrict__ out, int S, int C,
                     int n_tiles) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NV = BC / VEC;
  constexpr int RG = THREADS / NV;
  __shared__ float red[2][RG][BC];
  const int tile = blockIdx.x, c0 = blockIdx.y * BC, b = blockIdx.z;
  const int v = threadIdx.x % NV, rg = threadIdx.x / NV;
  const int c = c0 + v * VEC;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s1[e] = s2[e] = 0.f;
  if (c < C) {
    const T* base = x + ((size_t)b * S + (size_t)tile * TILE_ROWS) * C + c;
    const int rows = min(TILE_ROWS, S - tile * TILE_ROWS);
    for (int r = rg; r < rows; r += RG) {
      union {
        uint4 u;
        T h[VEC];
      } p;
      p.u = *reinterpret_cast<const uint4*>(base + (size_t)r * C);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float f;
        if constexpr (sizeof(T) == 2)
          f = __bfloat162float(p.h[e]);
        else
          f = p.h[e];
        s1[e] += f;
        s2[e] = fmaf(f, f, s2[e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    red[0][rg][v * VEC + e] = s1[e];
    red[1][rg][v * VEC + e] = s2[e];
  }
  __syncthreads();
  if (threadIdx.x < 2 * BC) {
    const int which = threadIdx.x / BC, cc = threadIdx.x % BC;
    if (c0 + cc < C) {
      float s = 0.f;
#pragma unroll 8
      for (int g = 0; g < RG; ++g) s += red[which][g][cc];
      out[(((size_t)b * n_tiles + tile) * 2 + which) * C + c0 + cc] = s;
    }
  }
}

// A block-wide sum, in a fixed order: each warp by shuffles, then the
// warps' sums in warp order. Every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) s += scratch[w];
  __syncthreads();
  return s;
}

template <typename A>
__device__ __forceinline__ float to_f(A v) {
  if constexpr (sizeof(A) == 2)
    return __bfloat162float(v);
  else
    return v;
}

// Block (group, b): the group's partials (B, n_tiles, 2, C) -> a, b (B, C).
template <typename A>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ part, const A* __restrict__ scale,
               const A* __restrict__ bias, float* __restrict__ ga, float* __restrict__ gb,
               int n_tiles, int C, int cg, float inv_n, float eps) {
  __shared__ float scratch[THREADS / 32];
  const int g = blockIdx.x, b = blockIdx.y;
  const int c0 = g * cg, n = n_tiles * cg;
  const float* base = part + (size_t)b * n_tiles * 2 * C + c0;
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int t = i / cg, c = i % cg;
    s1 += base[(size_t)t * 2 * C + c];
    s2 += base[(size_t)t * 2 * C + C + c];
  }
  s1 = block_sum(s1, scratch);
  s2 = block_sum(s2, scratch);
  const float mean = s1 * inv_n;
  const float var = fmaxf(fmaf(-mean, mean, s2 * inv_n), 0.f);
  const float inv = rsqrtf(var + eps);
  for (int c = threadIdx.x; c < cg; c += THREADS) {
    const float a = inv * to_f(scale[c0 + c]);
    ga[(size_t)b * C + c0 + c] = a;
    gb[(size_t)b * C + c0 + c] = fmaf(-mean, a, to_f(bias[c0 + c]));
  }
}

int launch_stats(const void* x, int x_bf16, float* part, int B, int S, int C,
                 cudaStream_t stream) {
  const int n_tiles = (S + TILE_ROWS - 1) / TILE_ROWS;
  const dim3 grid(n_tiles, (C + BC - 1) / BC, B);
  if (x_bf16)
    partial_stats_kernel<bf16><<<grid, THREADS, 0, stream>>>(static_cast<const bf16*>(x), part,
                                                             S, C, n_tiles);
  else
    partial_stats_kernel<float><<<grid, THREADS, 0, stream>>>(static_cast<const float*>(x),
                                                              part, S, C, n_tiles);
  return (int)cudaGetLastError();
}

int launch_combine(const float* part, int n_tiles, const void* scale, const void* bias,
                   int affine_bf16, float* a, float* b, int B, int C, int G, float eps,
                   long long count, cudaStream_t stream) {
  const int cg = C / G;
  const float inv_n = (float)(1.0 / ((double)count * cg));
  const dim3 grid(G, B);
  if (affine_bf16)
    combine_kernel<bf16><<<grid, THREADS, 0, stream>>>(
        part, static_cast<const bf16*>(scale), static_cast<const bf16*>(bias), a, b, n_tiles, C,
        cg, inv_n, eps);
  else
    combine_kernel<float><<<grid, THREADS, 0, stream>>>(
        part, static_cast<const float*>(scale), static_cast<const float*>(bias), a, b, n_tiles,
        C, cg, inv_n, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, S, C) contiguous, bf16 (x_bf16 = 1, C a multiple of 8) or fp32 (C
// a multiple of 4), 16-byte aligned; part: (B, ceil(S / 256), 2, C) fp32.
int group_norm_partial_stats(const void* x, int x_bf16, void* part, int B, int S, int C,
                             void* stream) {
  return launch_stats(x, x_bf16, static_cast<float*>(part), B, S, C,
                      static_cast<cudaStream_t>(stream));
}

// part: (B, n_tiles, 2, C) fp32 partial sums over `count` elements a
// channel; scale, bias: (C,) bf16 (affine_bf16 = 1) or fp32; writes a and b,
// (B, C) fp32 each. C must be a multiple of G.
int group_norm_combine(const void* part, int n_tiles, const void* scale, const void* bias,
                       int affine_bf16, void* a, void* b, int B, int C, int G, float eps,
                       long long count, void* stream) {
  return launch_combine(static_cast<const float*>(part), n_tiles, scale, bias, affine_bf16,
                        static_cast<float*>(a), static_cast<float*>(b), B, C, G, eps, count,
                        static_cast<cudaStream_t>(stream));
}

// Both, in one call: x's partials into `part` (as group_norm_partial_stats),
// then the folded affine from them (count = S).
int group_norm_coeffs(const void* x, int x_bf16, void* part, const void* scale, const void* bias,
                      int affine_bf16, void* a, void* b, int B, int S, int C, int G, float eps,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_stats(x, x_bf16, static_cast<float*>(part), B, S, C, s);
  if (err) return err;
  return launch_combine(static_cast<const float*>(part), (S + TILE_ROWS - 1) / TILE_ROWS, scale,
                        bias, affine_bf16, static_cast<float*>(a), static_cast<float*>(b), B, C,
                        G, eps, S, s);
}

}  // extern "C"
