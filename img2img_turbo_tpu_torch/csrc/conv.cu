// The conv library: kernels K1, K4 and K6 of the TPU package, and K8's du,
// as bf16 implicit-GEMM convolutions for Hopper (sm_90a) over channels-last
// (NHWC) memory, on the warpgroup tensor-core instruction (wgmma).
//
// Replaces
//   K1  img2img_turbo_tpu/ops/fused_conv.py:889 fused_gn_silu_conv3x3
//       y = conv3x3_same(silu(x*a + b)) + bias [+ extra_bias] [+ skip_x@skip_w]
//           [+ residual], optional per-tile sum / sum^2 of the stored y;
//   K4  img2img_turbo_tpu/ops/fused_conv.py:1688 upsample2x_conv3x3
//       y = conv3x3(nearest_up2x(x)) + bias [+ skip_x@skip_w], as four phase
//       2x2 convolutions on the low-resolution x with folded weights;
//       K1 and K4 are the two modes of the engine, conv_kernel;
//   K6  img2img_turbo_tpu/ops/fused_conv.py:1350 downsample2x_conv3x3
//       y = stride-2 conv3x3 with (pad_lo, 1) padding on both axes + bias,
//       optional per-tile stats of the stored y (the VAE encoder chains them
//       into the next GroupNorm); down_kernel below, a kernel of its own;
//   K8's du, the input gradient of K1's conv in the backward of
//       img2img_turbo_tpu/models/layers.py:351 pallas_bwd (which runs K1 on
//       gy with the spatially flipped, io-swapped weights): du = conv_T(gy, w),
//       fp32 accumulation, one rounding; dgrad_kernel below, a kernel of its
//       own.
//
// The engine (K1, K4): a block (two warpgroups) owns a 16 x 8 tile of
// (low-resolution, for K4) pixels and 128 output channels. For each
// 32-channel chunk it loads the tile's input with a one-pixel halo ONCE into
// shared memory, applying the GroupNorm affine + SiLU prologue in fp32 on the
// way and rounding once to bf16; outside the image the halo is zero AFTER
// activation (SAME padding of the activated tensor). Every tap then reads
// that halo in place: the 9 taps of K1, or for K4 phase (a, b) the 4 taps at
// offsets (a+p, b+q) with the folded weights. The halo is stored as wgmma's
// no-swizzle core matrices ([channel/8][pixel][8]): a tile row is 8 pixels,
// so the 64 rows of one warpgroup's m64 operand are 8 core matrices at a
// fixed stride (one halo row) for every tap. Weights are packed once at load
// as (taps, C/8, Co, 8), the K-major core-matrix layout of the B operand, and
// stream through a 4-stage cp.async ring. The 1x1 skip (resnet shortcut or
// VAE zero-conv) continues the same accumulation over a tile of skip_x.
//
// The engine's epilogue sums bias, the per-(batch, channel) extra bias and
// the residual in fp32 and rounds once; stats are per-block partial sums of
// the stored (rounded) y, written as (B, n_tiles, 2, Co) without atomics, so
// every run is bit-identical.
//
// What bounds the engine on the H100: the UNet/VAE convolutions are compute
// bound (hundreds of FLOPs per byte). Each step waits for its wgmma group
// before the next barrier, and loads share the compute warps (no TMA, no warp
// specialisation yet). Grids under one wave of blocks (the UNet's 8x8 and
// 16x16 levels) split the channel chunks over several blocks (split-K): each
// writes fp32 partial sums to a workspace the wrapper allocates, and a second
// kernel adds them in a fixed order and runs the epilogue.

#include "hopper.cuh"

using i2i::bf16;
using i2i::Pack8;
using i2i::cp_async16;
using i2i::cp_async_commit;
using i2i::cp_async_wait;
using i2i::fence_proxy_async;
using i2i::smem_desc;

namespace {

constexpr int TH = 16, TW = 8;          // pixel tile: 16 rows x 8 columns
constexpr int BM = TH * TW;             // GEMM rows per block (2 x m64)
constexpr int BN = 128;                 // output channels per block
constexpr int BK = 32;                  // channels per chunk
constexpr int KCH = BK / 8;             // 8-channel core-matrix columns
constexpr int NT = 256;                 // threads: two warpgroups
constexpr int HWD = TW + 2;             // halo width
constexpr int HALO_PIX = (TH + 2) * HWD;
constexpr int A_CHUNKS = HALO_PIX * KCH;
constexpr int A_PER_T = (A_CHUNKS + NT - 1) / NT;
constexpr int STAGES = 4;               // weight-tile ring depth
constexpr int B_STAGE = KCH * BN * 8;   // bf16 elements per weight tile
constexpr int B_PER_T = KCH * BN / NT;
constexpr int NUM_SMS = 132;
// modes of the engine
constexpr int SAME = 0, UP2 = 1;
constexpr int CONV_SMEM = KCH * HALO_PIX * 16 + STAGES * B_STAGE * 2 + 8 * 2 * BN * 4;

struct ConvArgs {
  const bf16* x;      // (B, H, W, C); the low-resolution input for K4
  const bf16* w;      // packed (taps, C/8, CoP, 8); K4: 16 = 4 phases x 4 taps;
                      // the du: the forward's (9, Co/8, CoP, 8), CoP rows of K
  const float* bias;  // (Co) or null (zero)
  const float* ga;    // (B, C) folded GroupNorm scale, or null
  const float* gb;    // (B, C) folded GroupNorm shift
  const float* eb;    // (B, Co) or null
  const bf16* res;    // (B, Ho, Wo, Co) or null
  const bf16* skx;    // (B, Ho, Wo, Csk) or null
  const bf16* skw;    // packed (1, Csk/8, CoP, 8)
  bf16* y;            // (B, Ho, Wo, Co)
  float* stats;       // (B, n_tiles, 2, Co) or null
  float* ws;          // split-K: (splits, B, Ho, Wo, Co) fp32 partial sums
  int splits, chunks_per_split;
  int B, H, W, C, Co, Csk, CoP;
  int tiles_w, tiles;  // pixel tiles per row of tiles / per image (phase)
  int vec_a;           // C and Csk are multiples of 8
};

// Two blocks per SM: caps the kernel at 128 registers a thread (uncapped it
// takes 135, and one block alone cannot hide its own barrier stalls).
template <int MODE, bool NORM>
__global__ void __launch_bounds__(NT, 2) conv_kernel(ConvArgs p) {
  constexpr bool UP = MODE == UP2;
  constexpr int T = UP ? 4 : 9;
  constexpr int HP = HALO_PIX;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* halo = reinterpret_cast<bf16*>(smem);             // [KCH][HP][8]
  bf16* Bs = halo + KCH * HP * 8;                         // STAGES x [KCH][BN][8]
  float* red = reinterpret_cast<float*>(Bs + STAGES * B_STAGE);  // [8][2][BN]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7;  // warpgroup: tile rows 8*wg .. 8*wg+7
  const int b = blockIdx.z % p.B, split = blockIdx.z / p.B;
  const int ph = UP ? (int)blockIdx.x / p.tiles : 0;
  const int tile = (int)blockIdx.x - ph * p.tiles;
  const int i0 = (tile / p.tiles_w) * TH, j0 = (tile % p.tiles_w) * TW;
  const int n0 = blockIdx.y * BN;
  const int Ho = UP ? 2 * p.H : p.H, Wo = UP ? 2 * p.W : p.W;
  const int pa = ph >> 1, pb = ph & 1;
  const int KC = (p.C + BK - 1) / BK;
  const int KS = (p.Csk + BK - 1) / BK;
  const int kbeg = split * p.chunks_per_split;
  const int kend = min(kbeg + p.chunks_per_split, KC + KS);
  const int C8 = (p.C + 7) / 8, Csk8 = (p.Csk + 7) / 8;

  // ---- A operand: the chunk's halo tile (or the skip tile), via registers
  Pack8 ra[A_PER_T];
  bool rok[A_PER_T];
  int rdst[A_PER_T], rc[A_PER_T];
  bool rskip = false;

  auto fetch_a = [&](int k) {
    const bool skip = k >= KC;
    const int c0 = (skip ? k - KC : k) * BK;
    rskip = skip;
#pragma unroll
    for (int t = 0; t < A_PER_T; ++t) {
      const int q = tid + t * NT;
      const int pix = q / KCH, kc = q % KCH;
      const bf16* src = nullptr;
      int cx = 0;
      bool ok = false;
      int dst = -1;
      if (!skip) {
        if (pix < HALO_PIX) {
          const int hr = pix / HWD, hc = pix - hr * HWD;
          const int ih = i0 - 1 + hr, iw = j0 - 1 + hc;
          ok = ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
          src = p.x + (((size_t)b * p.H + ih) * p.W + iw) * p.C;
          cx = p.C;
          dst = kc * HP + pix;
        }
      } else if (pix < BM) {
        const int r = pix / TW, c = pix - r * TW;
        const int i = i0 + r, j = j0 + c;
        ok = i < p.H && j < p.W;
        const int ho = UP ? 2 * i + pa : i, wo = UP ? 2 * j + pb : j;
        src = p.skx + (((size_t)b * Ho + ho) * Wo + wo) * p.Csk;
        cx = p.Csk;
        dst = kc * HP + (r + 1) * HWD + c + 1;
      }
      const int c = c0 + kc * 8;
      rok[t] = ok;
      rc[t] = c;
      rdst[t] = dst;
      if (ok && p.vec_a) {
        ra[t] = c < cx ? *reinterpret_cast<const Pack8*>(src + c) : i2i::zero8();
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          ra[t].h[e] = (ok && c + e < cx) ? src[c + e] : __float2bfloat16(0.f);
      }
    }
  };

  auto store_a = [&]() {
#pragma unroll
    for (int t = 0; t < A_PER_T; ++t) {
      if (rdst[t] < 0) continue;
      Pack8 v = ra[t];
      if (NORM && !rskip) {
        const float* ga = p.ga + (size_t)b * p.C;
        const float* gb = p.gb + (size_t)b * p.C;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int c = rc[t] + e;
          float f = 0.f;
          if (rok[t] && c < p.C)
            f = i2i::silu(__bfloat162float(v.h[e]) * ga[c] + gb[c]);
          v.h[e] = __float2bfloat16(f);
        }
      }
      *reinterpret_cast<Pack8*>(&halo[rdst[t] * 8]) = v;
    }
  };

  // ---- B operand: one (chunk, tap) weight tile, [KCH][BN][8], into a stage
  auto load_b = [&](int k, int tap, int stage) {
    const bool skip = k >= KC;
    const int c8 = (skip ? k - KC : k) * KCH;
    const int kx8 = skip ? Csk8 : C8;
    const bf16* wbase = skip ? p.skw
                             : p.w + (size_t)(UP ? ph * 4 + tap : tap) * C8 * p.CoP * 8;
#pragma unroll
    for (int t = 0; t < B_PER_T; ++t) {
      const int q = tid + t * NT;
      const int kc = q / BN, n = q % BN;
      const bool ok = c8 + kc < kx8 && n0 + n < p.CoP;
      const bf16* src = wbase + ((size_t)(c8 + kc) * p.CoP + n0 + n) * 8;
      cp_async16(&Bs[stage * B_STAGE + (kc * BN + n) * 8], ok ? src : wbase, ok);
    }
  };

  float d[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) d[r] = 0.f;

  // Steps walk (chunk, tap) pairs of this block's chunk range; a skip
  // chunk has one tap.
  const int tap_steps = max(0, min(kend, KC) - kbeg) * T;
  const int nsteps = tap_steps + max(0, kend - max(kbeg, KC));
  auto step_at = [&](int i, int& k, int& tap) {
    if (i < tap_steps) {
      k = kbeg + i / T;
      tap = i % T;
    } else {
      k = max(kbeg, KC) + (i - tap_steps);
      tap = 0;
    }
  };

  fetch_a(kbeg);
  store_a();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) {
      int k, tap;
      step_at(st, k, tap);
      load_b(k, tap, st);
    }
    cp_async_commit();
  }
  for (int i = 0; i < nsteps; ++i) {
    int k, tap;
    step_at(i, k, tap);
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // B(i) and the halo are visible; step i-1 is done
    if (i + STAGES - 1 < nsteps) {
      int k2, tap2;
      step_at(i + STAGES - 1, k2, tap2);
      load_b(k2, tap2, (i + STAGES - 1) % STAGES);
    }
    cp_async_commit();
    const int ntaps = k < KC ? T : 1;
    const bool more = k + 1 < kend;
    if (tap == 0 && more) fetch_a(k + 1);
    int di = 1, dj = 1;  // the skip tile sits at the halo's centre
    if (k < KC) {
      if (UP) {
        di = pa + (tap >> 1);
        dj = pb + (tap & 1);
      } else {
        di = tap / 3;
        dj = tap % 3;
      }
    }
    // first entry of the warpgroup's 8 tile rows for this tap; tile rows
    // are one halo row apart
    const bf16* a0 = halo + ((wg * 8 + di) * HWD + dj) * 8;
    const bf16* b0 = Bs + (i % STAGES) * B_STAGE;
    i2i::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KCH / 2; ++ks) {
      const uint64_t da = smem_desc(a0 + 2 * ks * HP * 8, HP * 16, HWD * 16);
      const uint64_t db = smem_desc(b0 + 2 * ks * BN * 8, BN * 16, 128);
      i2i::wgmma_m64n128k16_ss(d, da, db, 1);
    }
    i2i::wgmma_commit();
    i2i::wgmma_wait<0>();
    if (tap == ntaps - 1 && more) {
      __syncthreads();  // every warp is done with this chunk's halo
      store_a();        // the next chunk's; published at the next step
    }
  }
  cp_async_wait<0>();

  // ---- Epilogue, from the wgmma accumulator layout: register 4j+2h+e of
  // thread (warp w of the warpgroup, lane l) holds row 16w + l/4 + 8h,
  // column 8j + 2(l%4) + e of the warpgroup's 64 x 128 tile.
  const int wq = warp & 3;
  const size_t split_off = (size_t)split * p.B * Ho * Wo * p.Co;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * wq + (lane >> 2) + 8 * h;   // row in the m64 tile
      const int pi = i0 + wg * 8 + (r >> 3), pj = j0 + (r & 7);
      const bool in = pi < p.H && pj < p.W;
      const int ho = UP ? 2 * pi + pa : pi, wo = UP ? 2 * pj + pb : pj;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * j + 2 * (lane & 3) + e;
        if (!in || n >= p.Co) continue;
        const size_t o = (((size_t)b * Ho + ho) * Wo + wo) * p.Co + n;
        const float acc = d[4 * j + 2 * h + e];
        if (p.splits > 1) {
          p.ws[split_off + o] = acc;
          continue;
        }
        float v = acc + (p.bias ? p.bias[n] : 0.f);
        if (p.eb) v += p.eb[(size_t)b * p.Co + n];
        if (p.res) v += __bfloat162float(p.res[o]);
        const bf16 yb = __float2bfloat16(v);
        p.y[o] = yb;
        const float f = __bfloat162float(yb);
        s1[e] += f;
        s2[e] += f * f;
      }
    }
    if (p.stats && p.splits == 1) {
      // sum the warp's 16 rows: lanes that share l%4 hold the same columns
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], off);
          s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], off);
        }
      }
      if (lane < 4) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * lane + e;
          red[(warp * 2 + 0) * BN + col] = s1[e];
          red[(warp * 2 + 1) * BN + col] = s2[e];
        }
      }
    }
  }
  if (p.stats && p.splits == 1) {
    __syncthreads();
    for (int nl = tid; nl < BN; nl += NT) {
      const int n = n0 + nl;
      if (n < p.Co) {
        float t1 = 0.f, t2 = 0.f;
        for (int w8 = 0; w8 < NT / 32; ++w8) {
          t1 += red[(w8 * 2 + 0) * BN + nl];
          t2 += red[(w8 * 2 + 1) * BN + nl];
        }
        float* st = p.stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * p.Co;
        st[n] = t1;
        st[p.Co + n] = t2;
      }
    }
  }
}

// Split-K second pass: add the splits' fp32 partial sums in a fixed order,
// then the same epilogue (bias, extra bias, residual, one rounding, stats
// of the stored y per pixel tile) as the single-pass kernel.
constexpr int EBN = 64;  // channels per epilogue block

template <bool UP>
__global__ void __launch_bounds__(NT) split_epilogue(ConvArgs p) {
  __shared__ float rs[2][NT];
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int ph = UP ? (int)blockIdx.x / p.tiles : 0;
  const int tile = (int)blockIdx.x - ph * p.tiles;
  const int i0 = (tile / p.tiles_w) * TH, j0 = (tile % p.tiles_w) * TW;
  const int Ho = UP ? 2 * p.H : p.H, Wo = UP ? 2 * p.W : p.W;
  const int pa = ph >> 1, pb = ph & 1;
  const int nl = tid % EBN, n = blockIdx.y * EBN + nl;
  const size_t split_stride = (size_t)p.B * Ho * Wo * p.Co;
  float s1 = 0.f, s2 = 0.f;
  if (n < p.Co) {
    for (int r = tid / EBN; r < BM; r += NT / EBN) {
      const int pi = i0 + r / TW, pj = j0 + r % TW;
      if (pi >= p.H || pj >= p.W) continue;
      const int ho = UP ? 2 * pi + pa : pi, wo = UP ? 2 * pj + pb : pj;
      const size_t o = (((size_t)b * Ho + ho) * Wo + wo) * p.Co + n;
      float v = 0.f;
      for (int sp = 0; sp < p.splits; ++sp) v += p.ws[sp * split_stride + o];
      if (p.bias) v += p.bias[n];
      if (p.eb) v += p.eb[(size_t)b * p.Co + n];
      if (p.res) v += __bfloat162float(p.res[o]);
      const bf16 yb = __float2bfloat16(v);
      p.y[o] = yb;
      const float f = __bfloat162float(yb);
      s1 += f;
      s2 += f * f;
    }
  }
  if (!p.stats) return;
  rs[0][tid] = s1;
  rs[1][tid] = s2;
  __syncthreads();
  if (tid < EBN && n < p.Co) {
    float t1 = 0.f, t2 = 0.f;
    for (int g = 0; g < NT / EBN; ++g) {
      t1 += rs[0][g * EBN + tid];
      t2 += rs[1][g * EBN + tid];
    }
    float* st = p.stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * p.Co;
    st[n] = t1;
    st[p.Co + n] = t2;
  }
}

// ---- K8's du, a kernel of its own -----------------------------------------
// du (B, H, W, C) = conv_T(gy (B, H, W, Co), w): the SAME conv of gy with
// the flipped, io-swapped weight, as an implicit GEMM with M = the block's
// pixel tile (16MT x 8: MT m64 tiles a warpgroup), N = 128 of the C du
// channels and K = 9 taps x Co gy channels, walked as (chunk of DBK
// channels, tap) steps. It reads the forward's packed weight (9, ceil(C/8),
// CoP, 8) as it is: tap t takes the forward's tap 8 - t, and for the product
// K is Co and N is C, so 8 consecutive co rows of one 8-channel group (16
// bytes along C) are an MN-major core matrix. A weight tile lands in shared
// memory as [C/8][DBK co][8] and wgmma reads it with the B-transpose bit.
//
// What bounds it on the H100: the VAE's and the UNet's 64^2 and 32^2 cases
// are compute bound (hundreds of FLOPs per byte of HBM); the conv_outs' du
// (Co = 3, 4, 8) is bound by its output's bytes, and the UNet's 8^2 and
// 16^2 levels by their weights' (split over the chunks). The design:
// - gy has no prologue, so each chunk's halo goes from device memory to
//   shared memory by cp.async, 16 bytes a copy, zero-filled outside the
//   image and past Co. Halos are double-buffered: chunk k+1's is issued at
//   chunk k's second tap (the first step at which every wgmma that read
//   that buffer for chunk k-1 has retired) and waited for with the weight
//   ring's own cp.async count, so the tensor cores never wait for a halo.
//   Where Co is not a multiple of 8 (the conv_outs' Co = 3, 4) gy's rows are
//   not 16-byte aligned: those cases load the halo by element (VEC false)
//   at the same point.
// - A step is one (chunk, tap): DBK = 64 channels, four k16 wgmmas per m64
//   tile (one where Co <= 16, DBK = 16). One committed group stays in
//   flight across the next step's barrier (wgmma_wait<1>): weight tiles are
//   loaded LEAD steps ahead into a ring of LEAD + 2 stages, so the stage
//   being refilled was read two steps back, by a group that has retired.
//   Each tile's first wgmma writes with scale_d = 0 (no zeroed
//   accumulators) and reg_fence pins the accumulators across the group in
//   flight, so ptxas does not serialise the wgmmas.
// - Where Co > 16 a block is one per SM and its ring as deep as shared
//   memory allows (LEAD 8 with the 16 x 8 tile, 6 with the 32 x 8), which
//   hides the weight stream's latency from L2 or HBM. The 32 x 8 tile (MT =
//   2, 128 accumulators a thread) shares each weight tile between twice the
//   pixels; the 16 x 8 one needs fewer splits and wastes fewer rows on
//   small or ragged images. dgrad_form picks one per call from the rates
//   measured for both. Co <= 16 keeps two blocks an SM (the output is what
//   costs there).
// - The epilogue rounds the fp32 tile to bf16 into shared memory (over the
//   halos and ring, free once the last group retired), then writes each
//   pixel's 256-byte channel row in 16-byte stores by 16 neighbouring
//   threads. Split-K (grids under one wave) writes fp32 partial sums to the
//   workspace instead, two channels a store, and dgrad_reduce adds them in a
//   fixed order, 8 channels a thread: no atomics, every run bit-identical.
constexpr int OUT_LD = BN + 8;  // bf16 per staged output row: 272 bytes, so a
                                // warp's 4-byte stores of 8 rows hit 32 banks
constexpr int SMEM_SM = 232448;  // shared memory one block may take

template <int MT, int DBK>
struct Dgrad {
  static constexpr int TH = 16 * MT;                   // tile rows
  static constexpr int BLOCKS = DBK == 16 ? 2 : 1;     // blocks an SM
  static constexpr int KCH = DBK / 8;
  static constexpr int HALO_PIX = (TH + 2) * HWD;
  // halo entries per 8-channel group: odd in 16-byte units, so the 8 groups
  // of one pixel's 128 bytes land in distinct banks
  static constexpr int HPS = HALO_PIX + 1;
  static constexpr int HALO = KCH * HPS * 8;           // bf16 per halo buffer
  static constexpr int STAGE = BN / 8 * DBK * 8;       // bf16 per weight stage
  static constexpr int FIT = (SMEM_SM / BLOCKS - 1024 - 4 * HALO) / (2 * STAGE);
  static constexpr int STAGES = FIT < 10 ? FIT : 10;   // weight ring depth
  // steps loaded ahead; at most 8, so that chunk k+1's halo, committed at
  // chunk k's second step, is complete when chunk k+1's first step waits
  // for its own weight tile
  static constexpr int LEAD = STAGES - 2;
  static_assert(LEAD >= 1 && LEAD <= 8, "weight ring depth");
  static constexpr int MAIN = (2 * HALO + STAGES * STAGE) * 2;
  static constexpr int OUT = BM * MT * OUT_LD * 2;     // staged output tile
  static constexpr int SMEM = MAIN > OUT ? MAIN : OUT;
};

// The product's K is the du's Co (p.C) and N its C (p.Co); p.CoP is the
// packed weight's rows per channel group, p.tiles_w the pixel tiles per row
// of tiles.
template <int MT, int DBK, bool VEC>
__global__ void __launch_bounds__(NT, Dgrad<MT, DBK>::BLOCKS) dgrad_kernel(ConvArgs p) {
  using G = Dgrad<MT, DBK>;
  constexpr int KCH = G::KCH, HPS = G::HPS, STAGES = G::STAGES, LEAD = G::LEAD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* halo = reinterpret_cast<bf16*>(smem);  // 2 x [KCH][HPS][8]
  bf16* Bs = halo + 2 * G::HALO;               // STAGES x [BN/8][DBK][8]
  bf16* out = reinterpret_cast<bf16*>(smem);   // epilogue: [BM * MT][OUT_LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7, wq = warp & 3;  // warpgroup: tile rows 8MT wg .. +8MT-1
  const int b = blockIdx.z % p.B, split = blockIdx.z / p.B;
  const int i0 = (blockIdx.x / p.tiles_w) * G::TH, j0 = (blockIdx.x % p.tiles_w) * TW;
  const int n0 = blockIdx.y * BN;
  const int kbeg = split * p.chunks_per_split;
  const int kend = min(kbeg + p.chunks_per_split, (p.C + DBK - 1) / DBK);
  const int nsteps = (kend - kbeg) * 9;

  // chunk k's halo into buffer buf: [kc][pixel][8], zero outside the image
  // and past Co
  auto load_halo = [&](int k, int buf) {
    bf16* hb = halo + buf * G::HALO;
    for (int q = tid; q < G::HALO_PIX * KCH; q += NT) {
      const int pix = q / KCH, kc = q % KCH;
      const int hr = pix / HWD, hc = pix - hr * HWD;
      const int ih = i0 - 1 + hr, iw = j0 - 1 + hc, c = k * DBK + kc * 8;
      const bool in = ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
      const bf16* src = p.x + (((size_t)b * p.H + ih) * p.W + iw) * p.C + c;
      bf16* dst = hb + (kc * HPS + pix) * 8;
      if constexpr (VEC) {
        const bool ok = in && c < p.C;
        cp_async16(dst, ok ? src : p.x, ok);
      } else {
        Pack8 v;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v.h[e] = in && c + e < p.C ? src[e] : __float2bfloat16(0.f);
        *reinterpret_cast<Pack8*>(dst) = v;
      }
    }
  };
  // step i's weight tile: the forward's tap 8 - tap, K rows k*DBK .. +DBK-1
  // of the block's 16 channel groups, as [16][DBK][8], into its ring stage
  auto load_w = [&](int i) {
    const int k = kbeg + i / 9, tap = i % 9;
    const int n8 = (p.Co + 7) / 8, g0 = n0 / 8, k0 = k * DBK;
    const bf16* wbase = p.w + (size_t)(8 - tap) * n8 * p.CoP * 8;
    bf16* st = Bs + (i % STAGES) * G::STAGE;
#pragma unroll
    for (int t = 0; t < BN / 8 * DBK / NT; ++t) {
      const int q = tid + t * NT;
      const int g = q / DBK, kr = q % DBK;
      const bool ok = g0 + g < n8 && k0 + kr < p.CoP;
      cp_async16(st + q * 8, ok ? wbase + ((size_t)(g0 + g) * p.CoP + k0 + kr) * 8 : p.w, ok);
    }
  };

  load_halo(kbeg, 0);
#pragma unroll
  for (int i = 0; i < LEAD; ++i) {
    if (i < nsteps) load_w(i);
    cp_async_commit();  // group i: step i's tile (and chunk kbeg's halo)
  }
  float d[MT][64];
  for (int i = 0; i < nsteps; ++i) {
    const int kk = i / 9, tap = i - 9 * kk;  // chunk kbeg + kk
    // step i's tile (group i) and every halo before it have landed; step
    // i-2's wgmmas have retired in every warpgroup after the barrier
    cp_async_wait<LEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    if (i + LEAD < nsteps) load_w(i + LEAD);
    if (tap == 1 && kbeg + kk + 1 < kend) load_halo(kbeg + kk + 1, (kk + 1) & 1);
    cp_async_commit();
    const int di = tap / 3, dj = tap - 3 * di;
    // an m64 tile's 8 tile rows for this tap: 8 core matrices one halo row
    // apart; K steps of 16 co rows are two core matrices (128 bytes) apart,
    // N's 8-channel groups DBK rows apart
    const bf16* a0 = halo + (kk & 1) * G::HALO + ((wg * 8 * MT + di) * HWD + dj) * 8;
    const bf16* b0 = Bs + (i % STAGES) * G::STAGE;
#pragma unroll
    for (int m = 0; m < MT; ++m) i2i::reg_fence(d[m]);
    i2i::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DBK / 16; ++ks) {
      const uint64_t db = smem_desc(b0 + ks * 16 * 8, 128, DBK * 16);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const uint64_t da =
            smem_desc(a0 + (m * 8 * HWD + 2 * ks * HPS) * 8, HPS * 16, HWD * 16);
        i2i::wgmma_m64n128k16_ss_tb(d[m], da, db, i > 0 || ks > 0);
      }
    }
    i2i::wgmma_commit();
    i2i::wgmma_wait<1>();
#pragma unroll
    for (int m = 0; m < MT; ++m) i2i::reg_fence(d[m]);
  }
  i2i::wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < MT; ++m) i2i::reg_fence(d[m]);
  cp_async_wait<0>();

  // register 4j+2h+e of d[m] in thread (warp wq of the warpgroup, lane l)
  // holds tile pixel 64 (MT wg + m) + 16 wq + l/4 + 8h, channel
  // n0 + 8j + 2(l%4) + e
  if (p.splits > 1) {
    float* ws = p.ws + (size_t)split * p.B * p.H * p.W * p.Co;
    const bool pair = p.Co % 2 == 0;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * (MT * wg + m) + 16 * wq + (lane >> 2) + 8 * h;
        const int pi = i0 + r / TW, pj = j0 + r % TW;
        if (pi >= p.H || pj >= p.W) continue;
        float* row = ws + (((size_t)b * p.H + pi) * p.W + pj) * p.Co;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = n0 + 8 * j + 2 * (lane & 3);
          const float v0 = d[m][4 * j + 2 * h], v1 = d[m][4 * j + 2 * h + 1];
          if (pair && n + 1 < p.Co) {
            *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
          } else {
            if (n < p.Co) row[n] = v0;
            if (n + 1 < p.Co) row[n + 1] = v1;
          }
        }
      }
    }
    return;
  }
  __syncthreads();  // every warpgroup is done with the halos and the ring
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * (MT * wg + m) + 16 * wq + (lane >> 2) + 8 * h;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + r * OUT_LD + 8 * j + 2 * (lane & 3)) =
            __floats2bfloat162_rn(d[m][4 * j + 2 * h], d[m][4 * j + 2 * h + 1]);
    }
  }
  __syncthreads();
  const bool vec_out = p.Co % 8 == 0;
#pragma unroll
  for (int t = 0; t < BM * MT * BN / 8 / NT; ++t) {
    const int q = tid + t * NT;
    const int r = q / (BN / 8), cg = q % (BN / 8);
    const int pi = i0 + r / TW, pj = j0 + r % TW, n = n0 + 8 * cg;
    if (pi >= p.H || pj >= p.W || n >= p.Co) continue;
    const Pack8 v = *reinterpret_cast<const Pack8*>(out + r * OUT_LD + 8 * cg);
    bf16* dst = p.y + (((size_t)b * p.H + pi) * p.W + pj) * p.Co + n;
    if (vec_out) {
      *reinterpret_cast<Pack8*>(dst) = v;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (n + e < p.Co) dst[e] = v.h[e];
    }
  }
}

// The du's split-K second pass: each thread adds one pixel's 8 channels
// over the splits in a fixed order (32-byte loads), rounds once and writes
// them in one 16-byte store.
__global__ void __launch_bounds__(NT) dgrad_reduce(ConvArgs p) {
  const long n8 = (p.Co + 7) / 8;
  const long q = (long)blockIdx.x * NT + threadIdx.x;
  if (q >= (long)p.B * p.H * p.W * n8) return;
  const long pix = q / n8;
  const int c0 = (int)(q - pix * n8) * 8;
  const size_t stride = (size_t)p.B * p.H * p.W * p.Co;
  const float* src = p.ws + pix * p.Co + c0;
  bf16* dst = p.y + pix * p.Co + c0;
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (p.Co % 8 == 0) {
#pragma unroll 4
    for (int sp = 0; sp < p.splits; ++sp) {
      const float4 a = *reinterpret_cast<const float4*>(src + sp * stride);
      const float4 c = *reinterpret_cast<const float4*>(src + sp * stride + 4);
      v[0] += a.x; v[1] += a.y; v[2] += a.z; v[3] += a.w;
      v[4] += c.x; v[5] += c.y; v[6] += c.z; v[7] += c.w;
    }
    Pack8 o;
#pragma unroll
    for (int e = 0; e < 8; ++e) o.h[e] = __float2bfloat16(v[e]);
    *reinterpret_cast<Pack8*>(dst) = o;
  } else {
    for (int e = 0; e < 8 && c0 + e < p.Co; ++e) {
      for (int sp = 0; sp < p.splits; ++sp) v[e] += src[sp * stride + e];
      dst[e] = __float2bfloat16(v[e]);
    }
  }
}

// ---- K6, a kernel of its own ----------------------------------------------
// Replaces img2img_turbo_tpu/ops/fused_conv.py:1350 downsample2x_conv3x3:
// y (B, Ho, Wo, Co) = the stride-2 conv3x3 of x (B, Hi, Wi, C) over (pad_lo,
// 1) padding on both axes, plus bias, fp32 accumulation, one rounding, and
// optionally the per-tile sum / sum^2 of the stored y over the true output.
// An implicit GEMM with M = the block's pixel tile (TH x 8 output pixels), N
// = 128 output channels and K = 9 taps x C, walked as (chunk, tap) steps.
// Output pixel (i, j) reads input (2i - pad_lo + di, 2j - pad_lo + dj).
//
// What bounds it on the H100: at the VAE's 512^2 and 256^2 levels the bytes
// of x; at 128^2 the operations; at the UNet's 32^2, 16^2 and 8^2 outputs
// (Co = 320-1280) the weights' bytes and a wave of too few blocks. What
// bounds this kernel: its copies. A step's wgmmas alone take ~530 cycles;
// issuing its cp.async copies (a weight tile and a slice of the next halo,
// 16-24 KB) takes the 256 threads as long again, and a halo copy costs ~3x
// a weight copy per byte (its address math). The design, the du's
// (dgrad_kernel above) as far as the stride-2 access allows:
// - A TH x 8 output tile reads a (2TH+1) x 17 input halo. The 8 outputs of
//   one core-matrix row read every other halo column, so each halo row is
//   stored as its 9 even columns followed by its 8 odd ones: tap (di, dj)
//   then reads 8 consecutive 16-byte entries of halo row 2r + di (even from
//   entry dj/2, odd from entry 9), and tile rows are two halo rows apart.
//   x has no prologue, so each chunk's halo goes from device memory to
//   shared memory by cp.async, zero-filled outside the image. Halos are
//   double-buffered; cp.async groups complete in order, so the next
//   chunk's halo is issued in slices over the current chunk's taps, each
//   waited for LEAD steps later with the weight ring's own count.
// - A step is one (chunk, tap): four k16 wgmmas a warpgroup. One committed
//   group stays in flight across the next step's barrier (wgmma_wait<1>):
//   weight tiles are loaded LEAD steps ahead into a ring of LEAD + 2
//   stages, so the stage being refilled was read two steps back, by a group
//   that has retired. Each tile's first wgmma writes with scale_d = 0 and
//   reg_fence pins the accumulators across the group in flight.
// - One block an SM, persistent: a block walks its share of the (pixel
//   tile, 128 channels, image) items with both rings running across items,
//   so the next item's first halo and weight tiles load during the current
//   item's last chunk and only the block's first item waits for them.
// - Three tiles: 32 x 8 in 32-channel chunks (two m64 tiles a warpgroup,
//   16 KB of copies a step), 16 x 8 in 64-channel chunks (24 KB a step),
//   and 8 x 8 in 64-channel chunks, whose warpgroups share the rows and take
//   64 channels each (m64n64: half the products, fewer wasted rows, twice
//   the blocks on small outputs). down_form picks the tile and the split
//   over the chunks per call.
// - The epilogue adds bias, rounds once into a staged tile in shared memory
//   (the last chunk's halo buffer, free once its group retired; 16-byte
//   groups permuted by row so the stores hit distinct banks), takes the
//   stats of the rounded values from it (two columns a thread, row groups
//   added in a fixed order: no atomics) and writes each pixel's 256-byte
//   channel row in 16-byte stores. Split-K (grids under one wave) writes
//   fp32 partial sums to the workspace instead, and down_reduce adds them
//   in split order, 8 channels a thread, with bias, one rounding, 16-byte
//   stores and the same per-tile stats: every run is bit-identical.
constexpr int DROW = 2 * TW + 1;  // halo entries a row: 9 even columns, 8 odd
constexpr int DEVEN = TW + 1;

// The three tiles: 32 x 8 in 32-channel chunks, whose warpgroups take 16
// rows (two m64 tiles) each; 16 x 8 in 64-channel chunks, 8 rows each; and
// 8 x 8 in 64-channel chunks, whose warpgroups share the rows and take 64
// channels each. Every step is the same product a block (128 pixels x 128
// channels x 64, or 256 x 128 x 32); the 32 x 8 tile moves 16 KB of halo
// and weights for it, the 16 x 8 24 KB.
template <int TH>
struct Down {
  static constexpr int MT = TH == 32 ? 2 : 1;           // m64 tiles a warpgroup
  static constexpr int WN = TH == 8 ? BN / 2 : BN;      // channels a warpgroup
  static constexpr int DBK = TH == 32 ? 32 : 64;        // channels a chunk
  static constexpr int KCH = DBK / 8;
  static constexpr int HALO_PIX = (2 * TH + 1) * DROW;  // 1105, 561 or 289: odd
  // in 16-byte units, so the 8 groups of one pixel's 128 bytes land in
  // distinct banks
  static constexpr int HALO = KCH * HALO_PIX * 8;       // bf16 per halo buffer
  static constexpr int STAGE = KCH * BN * 8;            // bf16 per weight stage
  static constexpr int FIT = (SMEM_SM - 1024 - 4 * HALO) / (2 * STAGE);
  static constexpr int CAP = TH == 32 ? 5 : 10;         // LEAD 3: the halo in 6 slices
  static constexpr int STAGES = FIT < CAP ? FIT : CAP;  // weight ring depth
  // steps loaded ahead: a stage is refilled two steps after it was read.
  // cp.async groups complete in order, one committed a step, so a group
  // committed at step s is waited for at step s + LEAD: the next chunk's
  // halo is issued in HSLICES slices at the current chunk's taps
  // 1 .. 9 - LEAD, the last one waited for at the next chunk's first step
  static constexpr int LEAD = STAGES - 2;
  static_assert(LEAD >= 1 && LEAD <= 8, "weight ring depth");
  static constexpr int HSLICES = 9 - LEAD;
  static constexpr int HALO_ITERS = (HALO_PIX * KCH + NT - 1) / NT;  // copies a thread
  // the epilogue's staged tile and its stats scratch [4 row groups][2][BN]
  // fit in one halo buffer
  static_assert(TH * TW * BN * 2 + 4 * 2 * BN * 4 <= HALO * 2, "staging");
  static constexpr int SMEM = (2 * HALO + STAGES * STAGE) * 2;
};

struct DownArgs {
  const bf16* x;      // (B, Hi, Wi, C)
  const bf16* w;      // packed (9, C/8, CoP, 8)
  const float* bias;  // (Co) or null (zero)
  bf16* y;            // (B, Ho, Wo, Co)
  float* stats;       // (B, tiles, 2, Co) or null
  float* ws;          // split-K: (splits, B, Ho, Wo, Co) fp32 partial sums
  int splits, chunks_per_split;
  int B, Hi, Wi, C, Co, CoP, Ho, Wo, pad;
  int tiles_w, tiles;  // pixel tiles per row of tiles / per image
};

// grid (blocks, 1, splits). A block walks the items (pixel tile, block of
// 128 output channels, image) blockIdx.x, blockIdx.x + gridDim.x, ... over
// its split's chunks, with both rings running across items: the next
// item's first halo and weight tiles load during the current item's last
// chunk, so only the block's first item waits for its prologue.
template <int TH>
__global__ void __launch_bounds__(NT, 1) down_kernel(DownArgs p) {
  using G = Down<TH>;
  constexpr int MT = G::MT, WN = G::WN, DBK = G::DBK, KCH = G::KCH, HP = G::HALO_PIX;
  constexpr int STAGES = G::STAGES, LEAD = G::LEAD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* halo = reinterpret_cast<bf16*>(smem);  // 2 x [KCH][HP][8]
  bf16* Bs = halo + 2 * G::HALO;               // STAGES x [KCH][BN][8]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7, wq = warp & 3;
  // the warpgroup's first tile row and first channel of the block's 128
  const int row0 = TH == 8 ? 0 : 8 * MT * wg;
  const int nw0 = TH == 8 ? WN * wg : 0;
  const int split = blockIdx.z;
  const int kbeg = split * p.chunks_per_split;
  const int nch = min(p.chunks_per_split, (p.C + DBK - 1) / DBK - kbeg);  // chunks an item
  const int NS = nch * 9;                                                 // steps an item
  const int nblk = (p.Co + BN - 1) / BN;
  const int items = p.tiles * nblk * p.B;
  const int nsteps = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * NS;
  // item it of this block: its tile (origin i0, j0), channel block n0, image b
  struct Item {
    int tile, i0, j0, n0, b;
  };
  auto item_at = [&](int it) {
    const int w = blockIdx.x + it * gridDim.x, rest = w / p.tiles;
    Item r;
    r.tile = w - rest * p.tiles;
    r.i0 = (r.tile / p.tiles_w) * TH;
    r.j0 = (r.tile % p.tiles_w) * TW;
    r.n0 = (rest % nblk) * BN;
    r.b = rest / nblk;
    return r;
  };

  // slice sl of channels c0 .. c0+DBK-1 of item `it`'s halo into buffer buf:
  // [kc][entry][8], zero outside the image (C is a multiple of 8, so a
  // 16-byte word is all channels or none). A thread's channel group is fixed
  // (NT is a multiple of KCH).
  auto load_halo = [&](const Item& it, int c0, int buf, int sl) {
    const int kc = tid % KCH, c = c0 + kc * 8;
    const bf16* xb = p.x + (size_t)it.b * p.Hi * p.Wi * p.C + c;
    bf16* hb = halo + buf * G::HALO + kc * HP * 8;
    const int t0 = sl * G::HALO_ITERS / G::HSLICES, t1 = (sl + 1) * G::HALO_ITERS / G::HSLICES;
    for (int pix = tid / KCH + t0 * (NT / KCH); pix < min(t1 * (NT / KCH), HP); pix += NT / KCH) {
      const int hr = pix / DROW, e = pix - hr * DROW;
      const int hc = e < DEVEN ? 2 * e : 2 * (e - DEVEN) + 1;
      const int ih = 2 * it.i0 - p.pad + hr, iw = 2 * it.j0 - p.pad + hc;
      const bool ok = ih >= 0 && ih < p.Hi && iw >= 0 && iw < p.Wi && c < p.C;
      cp_async16(hb + pix * 8, ok ? xb + ((size_t)ih * p.Wi + iw) * p.C : p.x, ok);
    }
  };
  // The weight loader's cursor: the item and step of the next tile to load,
  // that item's channel block and the tile's ring stage. A tile is
  // [KCH][BN][8]: a thread copies row n = tid % BN of groups tid / BN + 2t.
  int w_it = 0, w_i = 0, w_st = 0, w_n0 = item_at(0).n0;
  const int c8n = p.C / 8, wn = tid % BN, wkc = tid / BN;
  auto load_w = [&]() {
    const int c8 = (kbeg + w_i / 9) * KCH + wkc, tap = w_i % 9;
    const bf16* src = p.w + ((size_t)(tap * c8n + c8) * p.CoP + w_n0 + wn) * 8;
    bf16* st = Bs + w_st * G::STAGE + tid * 8;
    const bool nok = w_n0 + wn < p.CoP;
#pragma unroll
    for (int t = 0; t < KCH * BN / NT; ++t) {
      const bool ok = nok && c8 + 2 * t < c8n;
      cp_async16(st + t * NT * 8, ok ? src + (size_t)2 * t * p.CoP * 8 : p.w, ok);
    }
    w_st = w_st + 1 == STAGES ? 0 : w_st + 1;
    if (++w_i == NS) {
      w_i = 0;
      w_n0 = item_at(++w_it).n0;
    }
  };

  float d[MT][WN / 2];
  // register 4j+2h+e of d[m] in thread (warp wq of the warpgroup, lane l)
  // holds tile pixel 8 row0 + 64m + 16 wq + l/4 + 8h, channel n0 + nw0 +
  // 8j + 2(l%4) + e
  // The staged tile [TH * TW][BN]: element (r, col) at r * BN + col with the
  // 16-byte groups of row r permuted by r % 8, so that the 8 rows a warp
  // writes at once hit distinct banks.
  auto staged = [](int r, int col) { return r * BN + (col ^ ((r & 7) << 3)); };
  auto epilogue = [&](const Item& it, bf16* out) {
    if (p.splits > 1) {
      float* ws = p.ws + (size_t)split * p.B * p.Ho * p.Wo * p.Co;
      const bool pair = p.Co % 2 == 0;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 8 * row0 + 64 * m + 16 * wq + (lane >> 2) + 8 * h;
          const int pi = it.i0 + r / TW, pj = it.j0 + r % TW;
          if (pi >= p.Ho || pj >= p.Wo) continue;
          float* row = ws + (((size_t)it.b * p.Ho + pi) * p.Wo + pj) * p.Co;
#pragma unroll
          for (int j = 0; j < WN / 8; ++j) {
            const int n = it.n0 + nw0 + 8 * j + 2 * (lane & 3);
            const float v0 = d[m][4 * j + 2 * h], v1 = d[m][4 * j + 2 * h + 1];
            if (pair && n + 1 < p.Co) {
              *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
            } else {
              if (n < p.Co) row[n] = v0;
              if (n + 1 < p.Co) row[n + 1] = v1;
            }
          }
        }
      }
      return;
    }
    // round once (bias added) into the staged tile
    __syncthreads();  // every warpgroup is done with this halo buffer
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      const int col = nw0 + 8 * j + 2 * (lane & 3), n = it.n0 + col;
      const float b0v = n < p.Co && p.bias ? p.bias[n] : 0.f;
      const float b1v = n + 1 < p.Co && p.bias ? p.bias[n + 1] : 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 8 * row0 + 64 * m + 16 * wq + (lane >> 2) + 8 * h;
          *reinterpret_cast<__nv_bfloat162*>(out + staged(r, col)) = __floats2bfloat162_rn(
              d[m][4 * j + 2 * h] + b0v, d[m][4 * j + 2 * h + 1] + b1v);
        }
      }
    }
    __syncthreads();
    if (p.stats) {
      // sum and sum of squares of the rounded values of the image's pixels:
      // a thread sums two columns over every 4th row, then the 4 row groups
      // are added in a fixed order; no atomics
      float* red = reinterpret_cast<float*>(out + TH * TW * BN);  // [4][2][BN]
      const int cp = tid & 63, rg = tid >> 6;
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
      for (int r = rg; r < TH * TW; r += 4) {
        if (it.i0 + r / TW >= p.Ho || it.j0 + r % TW >= p.Wo) continue;
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(out + staged(r, 2 * cp));
        const float f0 = __low2float(v), f1 = __high2float(v);
        s1[0] += f0;
        s2[0] += f0 * f0;
        s1[1] += f1;
        s2[1] += f1 * f1;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[(rg * 2 + 0) * BN + 2 * cp + e] = s1[e];
        red[(rg * 2 + 1) * BN + 2 * cp + e] = s2[e];
      }
      __syncthreads();
      if (tid < BN && it.n0 + tid < p.Co) {
        float t1 = 0.f, t2 = 0.f;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          t1 += red[(g * 2 + 0) * BN + tid];
          t2 += red[(g * 2 + 1) * BN + tid];
        }
        float* st = p.stats + ((size_t)it.b * p.tiles + it.tile) * 2 * p.Co;
        st[it.n0 + tid] = t1;
        st[p.Co + it.n0 + tid] = t2;
      }
    }
    // each pixel's 256-byte channel row in 16-byte stores
    const bool vec_out = p.Co % 8 == 0;
#pragma unroll
    for (int t = 0; t < TH * TW * BN / 8 / NT; ++t) {
      const int q = tid + t * NT;
      const int r = q / (BN / 8), cg = q % (BN / 8);
      const int pi = it.i0 + r / TW, pj = it.j0 + r % TW, n = it.n0 + 8 * cg;
      if (pi >= p.Ho || pj >= p.Wo || n >= p.Co) continue;
      const Pack8 v = *reinterpret_cast<const Pack8*>(out + staged(r, 8 * cg));
      bf16* dst = p.y + (((size_t)it.b * p.Ho + pi) * p.Wo + pj) * p.Co + n;
      if (vec_out) {
        *reinterpret_cast<Pack8*>(dst) = v;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (n + e < p.Co) dst[e] = v.h[e];
      }
    }
  };

  // the halo's cursor: the item and channels of the chunk loading
  Item h_it = item_at(0);
  int h_c0 = kbeg * DBK;
  for (int sl = 0; sl < G::HSLICES; ++sl) load_halo(h_it, h_c0, 0, sl);
#pragma unroll
  for (int s = 0; s < LEAD; ++s) {
    if (s < nsteps) load_w();
    cp_async_commit();  // group s: step s's tile (and the first halo)
  }
  // the block's items in turn; step s counts over all of them, chunk gc = s / 9
  for (int s = 0, it = 0; s < nsteps; ++it) {
    const Item cur = item_at(it);
    for (int i = 0; i < NS; ++i, ++s) {
      const int gc = s / 9, kk = i / 9, tap = i - 9 * kk;
      // step s's tile (group s) and every halo slice before it have landed;
      // step s-2's wgmmas have retired in every warpgroup after the barrier
      cp_async_wait<LEAD - 1>();
      fence_proxy_async();
      __syncthreads();
      // this step's loads, into a stage and a halo buffer no group in flight
      // reads: the tile LEAD steps ahead, and a slice of the next chunk's
      // halo (its item and channels set at the chunk's first slice)
      if (s + LEAD < nsteps) load_w();
      if (tap >= 1 && tap <= G::HSLICES && s - tap + 9 < nsteps) {
        if (tap == 1) {
          h_it = kk + 1 < nch ? cur : item_at(it + 1);
          h_c0 = (kbeg + (kk + 1 < nch ? kk + 1 : 0)) * DBK;
        }
        load_halo(h_it, h_c0, (gc + 1) & 1, tap - 1);
      }
      cp_async_commit();
      // an m64 tile's 8 tile rows for this tap: 8 core matrices two halo
      // rows apart; K steps of 16 channels are two channel groups (2 HP
      // entries) apart
      const int di = tap / 3, dj = tap - 3 * di;
      const bf16* a0 = halo + (gc & 1) * G::HALO +
                       ((2 * row0 + di) * DROW + (dj == 1 ? DEVEN : dj >> 1)) * 8;
      const bf16* b0 = Bs + (s % STAGES) * G::STAGE + nw0 * 8;
#pragma unroll
      for (int m = 0; m < MT; ++m) i2i::reg_fence(d[m]);
      i2i::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DBK / 16; ++ks) {
        const uint64_t db = smem_desc(b0 + 2 * ks * BN * 8, BN * 16, 128);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint64_t da =
              smem_desc(a0 + (m * 16 * DROW + 2 * ks * HP) * 8, HP * 16, 2 * DROW * 16);
          if constexpr (WN == 128)
            i2i::wgmma_m64n128k16_ss(d[m], da, db, i > 0 || ks > 0);
          else
            i2i::wgmma_m64n64k16_ss(d[m], da, db, i > 0 || ks > 0);
        }
      }
      i2i::wgmma_commit();
      i2i::wgmma_wait<1>();
#pragma unroll
      for (int m = 0; m < MT; ++m) i2i::reg_fence(d[m]);
    }
    // the item's last group retired, then its epilogue, staged in the last
    // chunk's halo buffer (the next item's first chunk loads into the other)
    i2i::wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m) i2i::reg_fence(d[m]);
    epilogue(cur, halo + ((s - 1) / 9 & 1) * G::HALO);
  }
  cp_async_wait<0>();
}

// K6's split-K second pass, one block per (pixel tile, 64 channels, image):
// each thread adds one pixel's 8 channels over the splits in split order
// (32-byte loads), adds bias, rounds once and writes them in one 16-byte
// store, for every 32nd pixel of the tile; the tile's stats of the rounded
// values are then summed over the 32 pixel slots in a fixed order.
template <int TH>
__global__ void __launch_bounds__(NT) down_reduce(DownArgs p) {
  __shared__ float rs[2][NT][8];
  const int tid = threadIdx.x, g = tid & 7, slot = tid >> 3;
  const int b = blockIdx.z, tile = blockIdx.x;
  const int i0 = (tile / p.tiles_w) * TH, j0 = (tile % p.tiles_w) * TW;
  const int c0 = blockIdx.y * 64 + 8 * g;
  const size_t stride = (size_t)p.B * p.Ho * p.Wo * p.Co;
  float s1[8], s2[8], bb[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    s1[e] = s2[e] = 0.f;
    bb[e] = c0 + e < p.Co && p.bias ? p.bias[c0 + e] : 0.f;
  }
  for (int r = slot; r < TH * TW && c0 < p.Co; r += NT / 8) {
    const int pi = i0 + r / TW, pj = j0 + r % TW;
    if (pi >= p.Ho || pj >= p.Wo) continue;
    const size_t o = (((size_t)b * p.Ho + pi) * p.Wo + pj) * p.Co + c0;
    const float* src = p.ws + o;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    Pack8 yv;
    if (p.Co % 8 == 0) {
#pragma unroll 4
      for (int sp = 0; sp < p.splits; ++sp) {
        const float4 a = *reinterpret_cast<const float4*>(src + sp * stride);
        const float4 c = *reinterpret_cast<const float4*>(src + sp * stride + 4);
        v[0] += a.x; v[1] += a.y; v[2] += a.z; v[3] += a.w;
        v[4] += c.x; v[5] += c.y; v[6] += c.z; v[7] += c.w;
      }
    } else {
      for (int e = 0; e < 8 && c0 + e < p.Co; ++e)
        for (int sp = 0; sp < p.splits; ++sp) v[e] += src[sp * stride + e];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      yv.h[e] = __float2bfloat16(v[e] + bb[e]);
      const float f = c0 + e < p.Co ? __bfloat162float(yv.h[e]) : 0.f;
      s1[e] += f;
      s2[e] += f * f;
    }
    bf16* dst = p.y + o;
    if (p.Co % 8 == 0) {
      *reinterpret_cast<Pack8*>(dst) = yv;
    } else {
      for (int e = 0; e < 8 && c0 + e < p.Co; ++e) dst[e] = yv.h[e];
    }
  }
  if (!p.stats) return;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    rs[0][tid][e] = s1[e];
    rs[1][tid][e] = s2[e];
  }
  __syncthreads();
  const int n = blockIdx.y * 64 + tid;
  if (tid < 64 && n < p.Co) {
    float t1 = 0.f, t2 = 0.f;
    for (int sl = 0; sl < NT / 8; ++sl) {
      t1 += rs[0][sl * 8 + tid / 8][tid % 8];
      t2 += rs[1][sl * 8 + tid / 8][tid % 8];
    }
    float* st = p.stats + ((size_t)b * p.tiles + tile) * 2 * p.Co;
    st[n] = t1;
    st[p.Co + n] = t2;
  }
}

struct Plan {
  int splits, chunks_per_split;
};

// Below one wave of `nb` blocks, split the `nchunks` channel chunks so
// that about `target` blocks run, keeping at least 2 chunks per split and
// at most `most` splits.
Plan split_plan(long nb, int nchunks, long target, int most) {
  Plan pl;
  pl.splits = 1;
  if (nb < NUM_SMS) {
    pl.splits = (int)((target + nb - 1) / nb);
    pl.splits = max(1, min(pl.splits, min(most, nchunks / 2)));
  }
  pl.chunks_per_split = (nchunks + pl.splits - 1) / pl.splits;
  pl.splits = (nchunks + pl.chunks_per_split - 1) / pl.chunks_per_split;
  return pl;
}

// The engine's split: about two waves of blocks.
Plan plan(int B, int H, int W, int C, int Co, int Csk, bool up) {
  const long nb = (long)((H + TH - 1) / TH) * ((W + TW - 1) / TW) * (up ? 4 : 1) * B *
                  ((Co + BN - 1) / BN);
  return split_plan(nb, (C + BK - 1) / BK + (Csk + BK - 1) / BK, 2 * NUM_SMS, 8);
}

// The du's form for a call: its channels a chunk (dbk), its m64 tiles a
// warpgroup (mt: a 16mt x 8 pixel tile), its blocks before any split, and
// its split over the Co chunks (at most one wave of blocks, up to 16
// splits).
struct DgradForm {
  int dbk, mt;
  long blocks;
  Plan pl;
};

DgradForm dgrad_form_of(int B, int H, int W, int C, int Co, int dbk, int mt) {
  const int th = 16 * mt;
  DgradForm f{dbk, mt, (long)((H + th - 1) / th) * ((W + TW - 1) / TW) * B * ((C + BN - 1) / BN),
              {}};
  f.pl = split_plan(f.blocks, (Co + dbk - 1) / dbk, NUM_SMS - f.blocks + 1, 16);
  return f;
}

// Co <= 16: one k16 wgmma a tap on the 16 x 8 tile (one chunk, no split).
// Otherwise the 16 x 8 or the 32 x 8 tile, whichever this model of the
// measured rates (an H100 at ~600 TFLOP/s in the main loop) puts first: a
// 16 x 8 step ~0.45 us, a 32 x 8 one 1.7 times that (twice the products,
// the weight tile shared), in rounds of 132 blocks; a split adds ~2 us and
// its fp32 partial sums written and read at 3 TB/s.
DgradForm dgrad_form(int B, int H, int W, int C, int Co) {
  if (Co <= 16) return dgrad_form_of(B, H, W, C, Co, 16, 1);
  DgradForm best{};
  double best_us = 0.0;
  for (int mt = 1; mt <= 2; ++mt) {
    const DgradForm f = dgrad_form_of(B, H, W, C, Co, 64, mt);
    double us = (double)((f.blocks * f.pl.splits + NUM_SMS - 1) / NUM_SMS) *
                f.pl.chunks_per_split * 9 * 0.45 * (mt == 2 ? 1.7 : 1.0);
    if (f.pl.splits > 1) us += 2.0 + 2.0 * f.pl.splits * B * H * W * C * 4 / 3e6;
    if (mt == 1 || us < best_us) {
      best = f;
      best_us = us;
    }
  }
  return best;
}

// K6's form for a call: its tile rows (th: a th x 8 pixel tile), its
// items (pixel tile, 128 output channels, image) and its split over the
// chunks (32 channels with the 32 x 8 tile, else 64).
struct DownForm {
  int th;
  long items;
  Plan pl;
};

int down_size(int n, int pad_lo) { return (n + pad_lo - 2) / 2 + 1; }
int down_chunk(int th) { return th == 32 ? 32 : 64; }

// Blocks of a call: one an item where the chunks split (at most one wave),
// else one an SM, each walking its share of the items.
long down_blocks(const DownForm& f) {
  return f.pl.splits > 1 ? f.items * f.pl.splits : min(f.items, (long)NUM_SMS);
}

// Of the three tiles and every split of the chunks into at most 16 parts
// that stays within one wave, the form this model puts first: a step costs
// 0.55 us with the 32 x 8 or the 16 x 8 tile and 0.45 with the 8 x 8, a
// block's first halo and weight tiles 5.0 / 5.0 / 3.0 us once, an item's
// epilogue 2.5 / 1.5 / 1.0 us, in rounds of 132 blocks; a split adds 2 us
// and its fp32 partial sums written and read at 3 TB/s. The constants rank
// the forms as each form, forced, measured on an H100 at the paths' ten
// shapes (tools/time_kernels.py --only K6); the times it predicts run
// ~30% low.
DownForm down_form(int B, int H, int W, int C, int Co, int pad_lo) {
  const int Ho = down_size(H, pad_lo), Wo = down_size(W, pad_lo);
  DownForm best{};
  double best_us = 0.0;
  for (int th = 32; th >= 8; th /= 2) {
    const int nchunks = (C + down_chunk(th) - 1) / down_chunk(th);
    const double step = th == 8 ? 0.45 : 0.55, first = th == 8 ? 3.0 : 5.0,
                 epi = th == 32 ? 2.5 : th == 16 ? 1.5 : 1.0;
    const long items = (long)((Ho + th - 1) / th) * ((Wo + TW - 1) / TW) * B * ((Co + BN - 1) / BN);
    for (int s = 1; s <= min(16, nchunks); ++s) {
      Plan pl;
      pl.chunks_per_split = (nchunks + s - 1) / s;
      pl.splits = (nchunks + pl.chunks_per_split - 1) / pl.chunks_per_split;
      if (pl.splits != s) continue;  // the same split as a smaller s
      if (s > 1 && items * s > NUM_SMS) break;
      double us = first + (double)((items * s + NUM_SMS - 1) / NUM_SMS) *
                              (pl.chunks_per_split * 9 * step + epi);
      if (s > 1) us += 2.0 + 2.0 * s * B * Ho * Wo * Co * 4 / 3e6;
      if (best_us == 0.0 || us < best_us) {
        best = {th, items, pl};
        best_us = us;
      }
    }
  }
  return best;
}

template <int MODE, bool NORM>
int launch(const ConvArgs& a, cudaStream_t stream) {
  constexpr bool UP = MODE == UP2;
  constexpr int smem_bytes = CONV_SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel<MODE, NORM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.tiles * (UP ? 4 : 1), (a.Co + BN - 1) / BN, a.B * a.splits);
  conv_kernel<MODE, NORM><<<grid, NT, smem_bytes, stream>>>(a);
  if (a.splits > 1) {
    dim3 eg(a.tiles * (UP ? 4 : 1), (a.Co + EBN - 1) / EBN, a.B);
    split_epilogue<UP><<<eg, NT, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int MT, int DBK, bool VEC>
int launch_dgrad(ConvArgs a, cudaStream_t stream) {
  constexpr int smem_bytes = Dgrad<MT, DBK>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      dgrad_kernel<MT, DBK, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  a.tiles_w = (a.W + TW - 1) / TW;
  a.tiles = ((a.H + 16 * MT - 1) / (16 * MT)) * a.tiles_w;
  dim3 grid(a.tiles, (a.Co + BN - 1) / BN, a.B * a.splits);
  dgrad_kernel<MT, DBK, VEC><<<grid, NT, smem_bytes, stream>>>(a);
  if (a.splits > 1) {
    const long threads = (long)a.B * a.H * a.W * ((a.Co + 7) / 8);
    dgrad_reduce<<<(unsigned)((threads + NT - 1) / NT), NT, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int TH>
int launch_down(DownArgs a, long blocks, cudaStream_t stream) {
  constexpr int smem_bytes = Down<TH>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      down_kernel<TH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  a.tiles_w = (a.Wo + TW - 1) / TW;
  a.tiles = ((a.Ho + TH - 1) / TH) * a.tiles_w;
  down_kernel<TH><<<dim3((unsigned)(blocks / a.splits), 1, a.splits), NT, smem_bytes, stream>>>(a);
  if (a.splits > 1) down_reduce<TH><<<dim3(a.tiles, (a.Co + 63) / 64, a.B), NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of stats tiles per image: (H/16 x W/8 pixel tiles, rounded up),
// times 4 phases for the upsample.
int conv_stats_tiles(int H, int W, int up) {
  return ((H + TH - 1) / TH) * ((W + TW - 1) / TW) * (up ? 4 : 1);
}

// Bytes of fp32 split-K workspace conv3x3_bf16 needs for this call (0 when
// the call does not split).
long conv_workspace_bytes(int B, int H, int W, int C, int Co, int Csk, int up) {
  const Plan pl = plan(B, H, W, C, Co, Csk, up);
  if (pl.splits == 1) return 0;
  return (long)pl.splits * B * (up ? 4 : 1) * H * W * Co * 4;
}

// Bytes of fp32 split-K workspace conv3x3_dgrad_bf16 needs for a du of C
// channels from Co (0 when the call does not split).
long conv_dgrad_workspace_bytes(int B, int H, int W, int C, int Co) {
  const Plan pl = dgrad_form(B, H, W, C, Co).pl;
  if (pl.splits == 1) return 0;
  return (long)pl.splits * B * H * W * C * 4;
}

// The du's launch form for a call, as conv3x3_dgrad_bf16 takes it: out[0]
// channels a chunk, out[1] m64 tiles a warpgroup (a 16 out[1] x 8 pixel
// tile), out[2] blocks an SM, out[3] splits, out[4] chunks a split, out[5]
// blocks launched.
void conv_dgrad_plan(int B, int H, int W, int C, int Co, int* out) {
  const DgradForm f = dgrad_form(B, H, W, C, Co);
  out[0] = f.dbk;
  out[1] = f.mt;
  out[2] = f.dbk == 16 ? 2 : 1;
  out[3] = f.pl.splits;
  out[4] = f.pl.chunks_per_split;
  out[5] = (int)(f.blocks * f.pl.splits);
}

// up = 0: K1, w packed from (3,3,C,Co); up = 1: K4, w packed from the folded
// (2,2,2,2,C,Co), and the GroupNorm prologue is not taken. Packed weights
// are (taps, ceil(C/8), ceil(Co/8)*8, 8) bf16. Pointers that an option does
// not use are null; workspace holds conv_workspace_bytes() bytes (null when
// that is 0). Returns the first CUDA error of the launches, else 0.
int conv3x3_bf16(const void* x, const void* w, const void* bias, const void* ga,
                 const void* gb, const void* eb, const void* res, const void* skx,
                 const void* skw, void* y, void* stats, void* workspace, int B,
                 int H, int W, int C, int Co, int Csk, int up, void* stream) {
  ConvArgs a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.ga = static_cast<const float*>(ga);
  a.gb = static_cast<const float*>(gb);
  a.eb = static_cast<const float*>(eb);
  a.res = static_cast<const bf16*>(res);
  a.skx = static_cast<const bf16*>(skx);
  a.skw = static_cast<const bf16*>(skw);
  a.y = static_cast<bf16*>(y);
  a.stats = static_cast<float*>(stats);
  a.B = B; a.H = H; a.W = W; a.C = C; a.Co = Co; a.Csk = skx ? Csk : 0;
  a.CoP = (Co + 7) / 8 * 8;
  a.tiles_w = (W + TW - 1) / TW;
  a.tiles = ((H + TH - 1) / TH) * a.tiles_w;
  a.vec_a = (C % 8 == 0) && (a.Csk % 8 == 0);
  const Plan pl = plan(B, H, W, C, Co, a.Csk, up);
  a.splits = pl.splits;
  a.chunks_per_split = pl.chunks_per_split;
  a.ws = static_cast<float*>(workspace);
  if (pl.splits > 1 && !workspace) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (up) return launch<UP2, false>(a, s);
  if (ga) return launch<SAME, true>(a, s);
  return launch<SAME, false>(a, s);
}

// K6's pixel tiles per image for a call (x (B, H, W, C) -> Co channels),
// the stats' second dimension: the output in tiles of the call's form.
int downsample_stats_tiles(int B, int H, int W, int C, int Co, int pad_lo) {
  const DownForm f = down_form(B, H, W, C, Co, pad_lo);
  return ((down_size(H, pad_lo) + f.th - 1) / f.th) * ((down_size(W, pad_lo) + TW - 1) / TW);
}

// Bytes of fp32 split-K workspace downsample3x3_bf16 needs for this call (0
// when the call does not split).
long downsample_workspace_bytes(int B, int H, int W, int C, int Co, int pad_lo) {
  const Plan pl = down_form(B, H, W, C, Co, pad_lo).pl;
  if (pl.splits == 1) return 0;
  return (long)pl.splits * B * down_size(H, pad_lo) * down_size(W, pad_lo) * Co * 4;
}

// K6's launch form for a call: out[0] tile rows (a out[0] x 8 pixel tile),
// out[1] channels a chunk, out[2] weight ring stages, out[3] splits, out[4]
// chunks a split, out[5] items (pixel tile, 128 output channels, image),
// out[6] blocks launched (one an SM at a time).
void downsample_plan(int B, int H, int W, int C, int Co, int pad_lo, int* out) {
  const DownForm f = down_form(B, H, W, C, Co, pad_lo);
  out[0] = f.th;
  out[1] = down_chunk(f.th);
  out[2] = f.th == 32 ? Down<32>::STAGES : f.th == 16 ? Down<16>::STAGES : Down<8>::STAGES;
  out[3] = f.pl.splits;
  out[4] = f.pl.chunks_per_split;
  out[5] = (int)f.items;
  out[6] = (int)down_blocks(f);
}

// K6: y (B, Ho, Wo, Co) = stride-2 conv3x3 of x (B, H, W, C) with
// (pad_lo, 1) padding on both axes, plus bias; Ho = (H + pad_lo - 2)/2 + 1,
// likewise Wo. w is packed from (3,3,C,Co) as for K1; C must be a multiple
// of 8 and H, W at least 2. stats (B, downsample_stats_tiles(...), 2, Co)
// or null; workspace holds downsample_workspace_bytes(...) bytes (null when
// that is 0). Returns the first CUDA error, else 0.
int downsample3x3_bf16(const void* x, const void* w, const void* bias, void* y,
                       void* stats, void* workspace, int B, int H, int W, int C,
                       int Co, int pad_lo, void* stream) {
  if (C % 8 || H < 2 || W < 2 || pad_lo < 0 || pad_lo > 1)
    return (int)cudaErrorInvalidValue;
  DownArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<bf16*>(y);
  a.stats = static_cast<float*>(stats);
  a.B = B; a.Hi = H; a.Wi = W; a.pad = pad_lo;
  a.Ho = down_size(H, pad_lo); a.Wo = down_size(W, pad_lo);
  a.C = C; a.Co = Co;
  a.CoP = (Co + 7) / 8 * 8;
  const DownForm f = down_form(B, H, W, C, Co, pad_lo);
  a.splits = f.pl.splits;
  a.chunks_per_split = f.pl.chunks_per_split;
  a.ws = static_cast<float*>(workspace);
  if (a.splits > 1 && !workspace) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long blocks = down_blocks(f);
  if (f.th == 32) return launch_down<32>(a, blocks, s);
  return f.th == 16 ? launch_down<16>(a, blocks, s) : launch_down<8>(a, blocks, s);
}

// K8's du: du (B, H, W, C) = the input gradient of a 3x3 SAME conv of C -> Co
// channels at output gradient gy (B, H, W, Co), with no prologue and no
// bias, reading the forward's packed weight w (9, ceil(C/8), ceil(Co/8)*8,
// 8) as it is. workspace holds conv_dgrad_workspace_bytes(B, H, W, C, Co)
// bytes (null when that is 0). Returns the first CUDA error, else 0.
int conv3x3_dgrad_bf16(const void* gy, const void* w, void* du, void* workspace, int B, int H,
                       int W, int C, int Co, void* stream) {
  ConvArgs a = {};
  a.x = static_cast<const bf16*>(gy);
  a.w = static_cast<const bf16*>(w);
  a.y = static_cast<bf16*>(du);
  a.B = B; a.H = H; a.W = W;
  a.C = Co; a.Co = C;         // the product's K and N
  a.CoP = (Co + 7) / 8 * 8;   // the packed weight's rows per channel group
  const DgradForm f = dgrad_form(B, H, W, C, Co);
  a.splits = f.pl.splits;
  a.chunks_per_split = f.pl.chunks_per_split;
  a.ws = static_cast<float*>(workspace);
  if (a.splits > 1 && !workspace) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = Co % 8 == 0;
  if (f.dbk == 16)
    return vec ? launch_dgrad<1, 16, true>(a, s) : launch_dgrad<1, 16, false>(a, s);
  if (f.mt == 2)
    return vec ? launch_dgrad<2, 64, true>(a, s) : launch_dgrad<2, 64, false>(a, s);
  return vec ? launch_dgrad<1, 64, true>(a, s) : launch_dgrad<1, 64, false>(a, s);
}

}  // extern "C"
