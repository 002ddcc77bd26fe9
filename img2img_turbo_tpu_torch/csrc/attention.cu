// Flash attention: kernels K2 and K9 of the TPU package, for Hopper
// (sm_90a), one kernel on two layouts.
//
// Replaces img2img_turbo_tpu/ops/attention.py:204 flash_attention_folded
// (K2, body _flash_heads_kernel :151) on folded (B, S, H*hd) tensors, and
// :85 flash_attention (K9, body _flash_kernel :49) on (B, H, S, d) tensors:
// non-causal multi-head attention with an online softmax over KV blocks,
// fp32 running max / running sum / accumulator, and masks for ragged Sq and
// Skv. The kernel reads rows through (batch, head, row) strides, so the
// folded layout's heads are column ranges read in place (no head transpose
// touches memory) and the (B, H, S, d) layout is the same walk with other
// strides. K9's TPU kernel keeps all of KV resident per (b, h), a VMEM
// choice; here KV streams through shared memory in blocks as for K2.
//
// One block owns BQ query rows of one (batch, head). Per KV block it loads
// K and V tiles into shared memory, computes S = Q K^T with bf16 tensor-core
// MMAs (wmma, fp32 accumulate), updates the softmax state in fp32, rescales
// the fp32 output accumulator (kept in shared memory, because the wmma
// register layout does not expose rows) and adds P V, with P rounded to
// bf16 as the TPU kernel does. On request it also writes each row's
// logsumexp (m + log l, fp32, (B, Sq, H)), the residual the backward
// kernel K7 (attention_bwd.cu) rebuilds P from (`return_lse`, :204-290).
//
// What bounds it on the H100: at hd=64 the UNet self-attention is compute
// bound; the shared-memory accumulator round trip and the single-stage
// loads keep this first version well below the tensor-core rate. hd=512
// (the VAE mid attention, one head) does not fit an FA-style register
// accumulator at all: its accumulator (BQ x 512 fp32) lives in shared
// memory, and BQ = BKV = 32 keeps Q, K, V, S, P and O inside the 227 KB a
// block may use (about 173 KB).

#include "common.cuh"

using namespace nvcuda;
using i2i::bf16;
using i2i::Pack8;

namespace {

constexpr int NT = 256;

__host__ __device__ constexpr int align128(int n) { return (n + 127) / 128 * 128; }

template <int HD, int BQ, int BKV>
struct Smem {
  static constexpr int QLD = HD + 8, SLD = BKV + 4, PLD = BKV + 8, OLD = HD + 4;
  static constexpr int q = 0;
  static constexpr int k = q + align128(BQ * QLD * 2);
  static constexpr int v = k + align128(BKV * QLD * 2);
  static constexpr int s = v + align128(BKV * QLD * 2);
  static constexpr int pm = s + align128(BQ * SLD * 4);
  static constexpr int o = pm + align128(BQ * PLD * 2);
  static constexpr int m = o + align128(BQ * OLD * 4);
  static constexpr int l = m + align128(BQ * 4);
  static constexpr int al = l + align128(BQ * 4);
  static constexpr int bytes = al + align128(BQ * 4);
};

// Element strides of a (batch, head, row) walk; a row's HD values are
// contiguous.
struct Strides {
  long long b, h, s;
};

template <int HD, int BQ, int BKV>
__global__ void __launch_bounds__(NT)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ lse, int Sq, int Skv, Strides qs, Strides ks,
             float scale) {
  using L = Smem<HD, BQ, BKV>;
  constexpr int TPR = NT / BQ;  // threads per softmax row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::pm);
  float* Os = reinterpret_cast<float*>(smem + L::o);
  float* ms = reinterpret_cast<float*>(smem + L::m);
  float* ls = reinterpret_cast<float*>(smem + L::l);
  float* als = reinterpret_cast<float*>(smem + L::al);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t qbase = (size_t)(b * qs.b + h * qs.h);   // q and o
  const size_t kbase = (size_t)(b * ks.b + h * ks.h);   // k and v

  // Q tile; rows past Sq are zero and never stored.
  for (int c = tid; c < BQ * HD / 8; c += NT) {
    const int r = c / (HD / 8), cc = (c % (HD / 8)) * 8;
    Pack8 val = i2i::zero8();
    if (q0 + r < Sq)
      val = *reinterpret_cast<const Pack8*>(q + qbase + (size_t)(q0 + r) * qs.s + cc);
    *reinterpret_cast<Pack8*>(&Qs[r * L::QLD + cc]) = val;
  }
  for (int i = tid; i < BQ * L::OLD; i += NT) Os[i] = 0.f;
  for (int i = tid; i < BQ; i += NT) {
    ms[i] = -INFINITY;
    ls[i] = 0.f;
  }

  for (int kv0 = 0; kv0 < Skv; kv0 += BKV) {
    __syncthreads();  // previous iteration done with Ks/Vs/Ps
    for (int c = tid; c < BKV * HD / 8; c += NT) {
      const int r = c / (HD / 8), cc = (c % (HD / 8)) * 8;
      Pack8 kv = i2i::zero8(), vv = i2i::zero8();
      if (kv0 + r < Skv) {
        const size_t off = kbase + (size_t)(kv0 + r) * ks.s + cc;
        kv = *reinterpret_cast<const Pack8*>(k + off);
        vv = *reinterpret_cast<const Pack8*>(v + off);
      }
      *reinterpret_cast<Pack8*>(&Ks[r * L::QLD + cc]) = kv;
      *reinterpret_cast<Pack8*>(&Vs[r * L::QLD + cc]) = vv;
    }
    __syncthreads();

    // S = Q K^T
    constexpr int SF = (BQ / 16) * (BKV / 16);
    for (int f = warp; f < SF; f += NT / 32) {
      const int fr = f / (BKV / 16), fc = f % (BKV / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll 4
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(af, &Qs[fr * 16 * L::QLD + kk], L::QLD);
        wmma::load_matrix_sync(bfr, &Ks[fc * 16 * L::QLD + kk], L::QLD);
        wmma::mma_sync(acc, af, bfr, acc);
      }
      wmma::store_matrix_sync(&Ss[fr * 16 * L::SLD + fc * 16], acc, L::SLD,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // Online softmax, TPR consecutive lanes per row.
    {
      const int r = tid / TPR, sub = tid % TPR;
      const float m_old = ms[r];
      float mx = -INFINITY;
      for (int c = sub; c < BKV; c += TPR)
        if (kv0 + c < Skv) mx = fmaxf(mx, Ss[r * L::SLD + c] * scale);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = sub; c < BKV; c += TPR) {
        float pv = 0.f;
        if (kv0 + c < Skv) pv = expf(Ss[r * L::SLD + c] * scale - m_new);
        sum += pv;
        Ps[r * L::PLD + c] = __float2bfloat16(pv);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (sub == 0) {
        const float alpha = expf(m_old - m_new);
        als[r] = alpha;
        ls[r] = ls[r] * alpha + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < BQ * HD; i += NT) {
      const int r = i / HD, c = i % HD;
      Os[r * L::OLD + c] *= als[r];
    }
    __syncthreads();

    // O += P V
    constexpr int OF = (BQ / 16) * (HD / 16);
    for (int f = warp; f < OF; f += NT / 32) {
      const int fr = f / (HD / 16), fc = f % (HD / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* op = &Os[fr * 16 * L::OLD + fc * 16];
      wmma::load_matrix_sync(acc, op, L::OLD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(af, &Ps[fr * 16 * L::PLD + kk], L::PLD);
        wmma::load_matrix_sync(bfr, &Vs[kk * L::QLD + fc * 16], L::QLD);
        wmma::mma_sync(acc, af, bfr, acc);
      }
      wmma::store_matrix_sync(op, acc, L::OLD, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, c = i % HD;
    if (q0 + r < Sq)
      o[qbase + (size_t)(q0 + r) * qs.s + c] =
          __float2bfloat16(Os[r * L::OLD + c] / ls[r]);
  }
  // per-row logsumexp of the scaled scores, (B, Sq, H) fp32, for K7
  if (lse != nullptr)
    for (int r = tid; r < BQ; r += NT)
      if (q0 + r < Sq)
        lse[((size_t)b * Sq + q0 + r) * gridDim.y + h] = ms[r] + logf(ls[r]);
}

template <int HD, int BQ, int BKV>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
           int B, int Sq, int Skv, int H, bool folded, cudaStream_t stream) {
  using L = Smem<HD, BQ, BKV>;
  auto kern = flash_kernel<HD, BQ, BKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (err != cudaSuccess) return (int)err;
  const long long D = (long long)H * HD;
  // folded (B, S, H*hd): head h is columns [h*hd, (h+1)*hd) of each row;
  // (B, H, S, d): head h is a contiguous (S, d) matrix
  const Strides qs = folded ? Strides{Sq * D, HD, D} : Strides{Sq * D, (long long)Sq * HD, HD};
  const Strides ks = folded ? Strides{Skv * D, HD, D} : Strides{Skv * D, (long long)Skv * HD, HD};
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, L::bytes, stream>>>(q, k, v, o, lse, Sq, Skv, qs, ks,
                                       1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, Sq, H*hd), k/v: (B, Skv, H*hd), o: (B, Sq, H*hd), all bf16;
// lse: (B, Sq, H) fp32 or null. hd must be 64 or 512. Returns
// cudaGetLastError().
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int Sq, int Skv, int H, int hd,
                         void* stream) {
  auto* qq = static_cast<const bf16*>(q);
  auto* kk = static_cast<const bf16*>(k);
  auto* vv = static_cast<const bf16*>(v);
  auto* oo = static_cast<bf16*>(o);
  auto* ll = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch<64, 64, 64>(qq, kk, vv, oo, ll, B, Sq, Skv, H, true, s);
  if (hd == 512)
    return launch<512, 32, 32>(qq, kk, vv, oo, ll, B, Sq, Skv, H, true, s);
  return (int)cudaErrorInvalidValue;
}

// K9. q, o: (B, H, Sq, 64), k/v: (B, H, Skv, 64), all bf16 and contiguous.
// Returns cudaGetLastError().
int flash_attention_bhsd_bf16(const void* q, const void* k, const void* v, void* o,
                              int B, int H, int Sq, int Skv, void* stream) {
  return launch<64, 64, 64>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                            static_cast<const bf16*>(v), static_cast<bf16*>(o), nullptr,
                            B, Sq, Skv, H, false, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
