// LayerNorm + matmul engine: kernel K3 of the TPU package, for Hopper
// (sm_90a).
//
// Replaces img2img_turbo_tpu/ops/fused_matmul.py:223 _pallas (body _kernel
// :186, entry fused :321): an optional LayerNorm (fp32 row statistics)
// feeding 1-3 matmuls that share it, a per-output bias, an optional
// residual added AFTER the cast to bf16 (fused_matmul.py:216-220), and a
// gate mode (xn@wv+bv) * gelu_erf(xn@wg+bg) that reads diffusers' packed
// (C, 2Co) GEGLU weight: value half first, then the gate half.
//
// The matmuls run in this kernel's own body (bf16 wmma, fp32 accumulate),
// not through cuBLAS. A block owns 128 rows x BN output columns of one
// output (grid.z picks the output for the 2/3-output modes). It first
// computes its rows' LayerNorm mean and rstd (two passes, fp32, as the TPU
// kernel does), then normalises each x tile in fp32 on its way into shared
// memory and rounds it to bf16.
//
// What bounds it on the H100: the transformer projections at M=4096 are
// compute bound, the 77-row context projections and the deep 8x8/16x16
// levels are weight-bandwidth bound. This first version keeps one
// register-prefetched shared-memory stage.

#include "common.cuh"

using namespace nvcuda;
using i2i::bf16;
using i2i::Pack8;

namespace {

constexpr int BM = 128;
constexpr int BK = 32;
constexpr int NT = 256;
constexpr int A_LD = BK + 8;

struct MMArgs {
  const bf16* x;        // (M, C)
  const float* ln_s;    // (C) or null
  const float* ln_b;    // (C)
  const bf16* w[3];     // (C, ldw) each
  const float* bias[3]; // (Co) each; gate mode: packed (2Co)
  const bf16* res;      // (M, Co) or null
  bf16* y[3];           // (M, Co) each
  int M, C, Co, ldw;
  float eps;
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

template <int BN, bool LN, bool GATE>
__global__ void __launch_bounds__(NT) mm_kernel(MMArgs p) {
  constexpr int WM = 4, WN = 2;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int FM = WTM / 16, FN = WTN / 16;
  constexpr int NB = GATE ? 2 : 1;  // B operands (value, gate)
  constexpr int B_LD = BN + 8;
  constexpr int B_CHUNKS = BK * BN / 8;
  constexpr int B_PER_T = (B_CHUNKS + NT - 1) / NT;

  __shared__ __align__(128) bf16 As[BM * A_LD];
  __shared__ __align__(128) bf16 Bs[NB][BK * B_LD];
  __shared__ __align__(128) float scr[NB][8 * 256];
  __shared__ float mean_s[BM], rstd_s[BM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp / WN, warp_n = warp % WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, z = blockIdx.z;
  const bf16* w = p.w[z];
  const float* bias = p.bias[z];
  bf16* y = p.y[z];

  if (LN) {
    // 16 rows per warp; two fp32 passes over each row (mean, then var).
    for (int r = warp; r < BM; r += NT / 32) {
      const int m = m0 + r;
      float mean = 0.f, var = 0.f;
      if (m < p.M) {
        const bf16* xr = p.x + (size_t)m * p.C;
        float s = 0.f;
        for (int c = lane * 8; c < p.C; c += 256) {
          Pack8 v = *reinterpret_cast<const Pack8*>(xr + c);
#pragma unroll
          for (int e = 0; e < 8; ++e) s += __bfloat162float(v.h[e]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        mean = s / p.C;
        float s2 = 0.f;
        for (int c = lane * 8; c < p.C; c += 256) {
          Pack8 v = *reinterpret_cast<const Pack8*>(xr + c);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float d = __bfloat162float(v.h[e]) - mean;
            s2 += d * d;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s2 += __shfl_xor_sync(0xffffffffu, s2, off);
        var = s2 / p.C;
      }
      if (lane == 0) {
        mean_s[r] = mean;
        rstd_s[r] = rsqrtf(var + p.eps);
      }
    }
    __syncthreads();
  }

  int a_row[2], a_col[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int q = tid + t * NT;
    a_row[t] = q >> 2;
    a_col[t] = (q & 3) * 8;
  }
  Pack8 ra[2], rb[NB][B_PER_T];
  int rc = 0;

  auto fetch = [&](int c0) {
    rc = c0;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int m = m0 + a_row[t], c = c0 + a_col[t];
      ra[t] = (m < p.M && c < p.C)
                  ? *reinterpret_cast<const Pack8*>(p.x + (size_t)m * p.C + c)
                  : i2i::zero8();
    }
#pragma unroll
    for (int g = 0; g < NB; ++g)
#pragma unroll
      for (int t = 0; t < B_PER_T; ++t) {
        const int q = tid + t * NT;
        if (q < B_CHUNKS) {
          const int row = q / (BN / 8), col = (q % (BN / 8)) * 8;
          const int k = c0 + row, n = n0 + col;
          rb[g][t] = (k < p.C && n < p.Co)
                         ? *reinterpret_cast<const Pack8*>(
                               w + (size_t)k * p.ldw + g * p.Co + n)
                         : i2i::zero8();
        }
      }
  };

  auto store = [&]() {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      Pack8 v = ra[t];
      if (LN) {
        const int m = m0 + a_row[t];
        const float mu = mean_s[a_row[t]], rs = rstd_s[a_row[t]];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int c = rc + a_col[t] + e;
          float f = 0.f;
          if (m < p.M && c < p.C)
            f = (__bfloat162float(v.h[e]) - mu) * rs * p.ln_s[c] + p.ln_b[c];
          v.h[e] = __float2bfloat16(f);
        }
      }
      *reinterpret_cast<Pack8*>(&As[a_row[t] * A_LD + a_col[t]]) = v;
    }
#pragma unroll
    for (int g = 0; g < NB; ++g)
#pragma unroll
      for (int t = 0; t < B_PER_T; ++t) {
        const int q = tid + t * NT;
        if (q < B_CHUNKS) {
          const int row = q / (BN / 8), col = (q % (BN / 8)) * 8;
          *reinterpret_cast<Pack8*>(&Bs[g][row * B_LD + col]) = rb[g][t];
        }
      }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB][FM][FN];
#pragma unroll
  for (int g = 0; g < NB; ++g)
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[g][i][j], 0.0f);

  const int nsteps = (p.C + BK - 1) / BK;
  fetch(0);
  store();
  __syncthreads();
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) fetch((s + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], &As[(warp_m * WTM + i * 16) * A_LD + kk], A_LD);
#pragma unroll
      for (int g = 0; g < NB; ++g)
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(bfr, &Bs[g][kk * B_LD + warp_n * WTN + j * 16], B_LD);
#pragma unroll
          for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[g][i][j], af[i], bfr, acc[g][i][j]);
        }
    }
    __syncthreads();
    if (s + 1 < nsteps) {
      store();
      __syncthreads();
    }
  }

  float* ws0 = scr[0] + warp * 256;
  float* ws1 = scr[NB - 1] + warp * 256;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(ws0, acc[0][i][j], 16, wmma::mem_row_major);
      if (GATE) wmma::store_matrix_sync(ws1, acc[NB - 1][i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + warp_m * WTM + i * 16 + (e >> 4);
        const int n = n0 + warp_n * WTN + j * 16 + (e & 15);
        if (m < p.M && n < p.Co) {
          float v = ws0[e] + bias[n];
          if (GATE) v *= gelu_erf(ws1[e] + bias[p.Co + n]);
          const size_t o = (size_t)m * p.Co + n;
          bf16 yb = __float2bfloat16(v);
          if (p.res) yb = __float2bfloat16(__bfloat162float(yb) + __bfloat162float(p.res[o]));
          y[o] = yb;
        }
      }
      __syncwarp();
    }
}

template <int BN, bool GATE>
void launch(const MMArgs& a, int n_out, cudaStream_t s) {
  dim3 grid((a.M + BM - 1) / BM, (a.Co + BN - 1) / BN, n_out);
  if (a.ln_s)
    mm_kernel<BN, true, GATE><<<grid, NT, 0, s>>>(a);
  else
    mm_kernel<BN, false, GATE><<<grid, NT, 0, s>>>(a);
}

}  // namespace

extern "C" {

// x (M, C) bf16; ln_s/ln_b fp32 (C) or null; w0..w2 bf16 (C, ldw); b0..b2
// fp32; res bf16 (M, Co) or null (one output only); y0..y2 bf16 (M, Co).
// gate = 1: w0 is the packed (C, 2Co) GEGLU weight (ldw = 2Co) and b0 the
// packed (2Co) bias; one output. C and Co must be multiples of 8.
// Returns cudaGetLastError().
int fused_matmul_bf16(const void* x, const void* ln_s, const void* ln_b,
                      const void* w0, const void* w1, const void* w2,
                      const void* b0, const void* b1, const void* b2,
                      const void* res, void* y0, void* y1, void* y2, int M, int C,
                      int Co, int ldw, int n_out, int gate, float eps, void* stream) {
  MMArgs a;
  a.x = static_cast<const bf16*>(x);
  a.ln_s = static_cast<const float*>(ln_s);
  a.ln_b = static_cast<const float*>(ln_b);
  a.w[0] = static_cast<const bf16*>(w0);
  a.w[1] = static_cast<const bf16*>(w1);
  a.w[2] = static_cast<const bf16*>(w2);
  a.bias[0] = static_cast<const float*>(b0);
  a.bias[1] = static_cast<const float*>(b1);
  a.bias[2] = static_cast<const float*>(b2);
  a.res = static_cast<const bf16*>(res);
  a.y[0] = static_cast<bf16*>(y0);
  a.y[1] = static_cast<bf16*>(y1);
  a.y[2] = static_cast<bf16*>(y2);
  a.M = M; a.C = C; a.Co = Co; a.ldw = ldw; a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gate)
    launch<64, true>(a, 1, s);
  else
    launch<128, false>(a, n_out, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
