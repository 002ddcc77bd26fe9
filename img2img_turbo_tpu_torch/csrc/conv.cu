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
// The engine (K1, K4), conv_kernel: an implicit GEMM with M = a block's
// pixels, N = its output channels and K = taps x C, walked as (chunk, tap)
// steps, then the 1x1 skip's (resnet shortcut or VAE zero-conv) steps over
// a tile of skip_x that continue the same accumulation. conv_form picks a
// form per call: a 16 x 8 tile over 128 output channels, two blocks an SM;
// a small-N form for Co <= 32 (the conv_outs: 32 channels, m64n32, on a
// 32 x 8 tile, two m64 tiles a warpgroup, or on the 16 x 8 one for small
// grids); a 16-channel form for C not a multiple of 8 (the conv_ins); a
// split over the chunks for grids under one wave; and for K4 a
// 16 x 8 tile of the low-resolution input and 64 output channels, each
// warpgroup taking 8 of its rows in all four phases of the 32 x 16 output
// (four m64 tiles). The design:
// - The chunk's halo (the tile and a one-pixel border) is loaded ONCE into
//   shared memory with the GroupNorm affine + SiLU prologue applied in fp32
//   and rounded once to bf16, zero outside the image AFTER activation (SAME
//   padding of the activated tensor) and past C; every tap reads it in
//   place (K4: phase (a, b) reads the offsets (a+p, b+q) of its folded 2x2
//   taps, so one halo serves all four phases). It is stored as wgmma's
//   no-swizzle core matrices ([channel/8][pixel][8]): a tile row is 8
//   pixels, so an m64 operand is 8 core matrices one halo row apart for
//   every tap. Halos are double-buffered: the next chunk's goes raw from
//   device memory into the other buffer by cp.async at the current
//   chunk's tap 1 (zero-filled outside the image and past C), is waited
//   for LEAD steps later with the weight ring's own count, and is then
//   activated in place in slices, each while a step's wgmma group runs,
//   so the prologue's copies and arithmetic overlap the tensor cores with
//   no barrier but the step's own. The conv_ins (C = 3, 4, rows not 16-byte
//   aligned) load their halo by element instead.
// - A step is one (chunk, tap): 64 channels, four k16 wgmmas per m64 tile
//   (K4: four weight tiles, one per phase). One committed
//   group stays in flight across the next step's barrier (wgmma_wait<1>):
//   weight tiles are loaded LEAD steps ahead by cp.async into a ring of
//   LEAD + 2 stages, so the stage being refilled was read two steps back,
//   by a group that has retired. A skip step's skip_x tile and weights
//   share a ring stage. Each tile's first wgmma writes with scale_d = 0 and
//   reg_fence pins the accumulators across the group in flight. Weights are
//   packed once at load as (taps, C/8, Co, 8), the K-major core-matrix
//   layout of the B operand.
// - The epilogue stages the fp32 tile in shared memory (over the halos and
//   the ring); each thread then takes 8 channels of a pixel, adds bias, the
//   per-(batch, channel) extra bias and the residual (a 16-byte read) in
//   fp32, rounds once, writes y in one 16-byte store and sums the stats of
//   the rounded values, added over the tile's row groups in a fixed order.
//   Grids under one wave split the chunks (split-K): each split writes its
//   fp32 partial sums to a workspace the wrapper allocates, and conv_reduce
//   adds them in split order, 8 channels a thread, with the same epilogue.
//   Stats are per-tile partial sums (B, tiles, 2, Co) in the form's tiles,
//   without atomics: every run is bit-identical.
//
// What bounds the engine on the H100, as measured (tools/k1_variants.py; an
// H100 80GB HBM3 at 700 W): the VAE's and UNet's convs are compute bound
// (hundreds of FLOPs per byte), and the engine reaches 31-38% of the bf16
// bound on the VAE's, 17-29% on the UNet's 64^2 and 32^2 levels, K4 28-34%
// on the VAE's. A 16 x 8 block, two sharing an SM, takes ~2,070 cycles a
// step whose wgmmas need ~490: a third of it issuing the step's cp.async
// copies (4 a thread for a weight tile, 8 for K4's four), a fifth its
// slice of the activation (two MUFU operations an element), most of the
// rest issuing its wgmmas behind the other block's; each block's prologue
// (the first halo from device memory, activated whole) and epilogue add a
// third again. TMA bulk copies of the weight tiles, one thread or one
// warp issuing them onto an mbarrier a stage, were slower, and so were the
// 32 x 8 tile and the 16 x 8 one at one block an SM with a deeper ring. The
// small-N conv_outs (Co = 3, 4, 8) are bound by their halos' copies and
// SiLU over 128-512 input channels, at ~6x their byte bound.

#include "hopper.cuh"

using i2i::bf16;
using i2i::Pack8;
using i2i::cp_async16;
using i2i::cp_async_commit;
using i2i::cp_async_wait;
using i2i::fence_proxy_async;
using i2i::smem_desc;

namespace {

constexpr int TW = 8;                   // pixel tile columns: one core-matrix row
constexpr int BM = 16 * TW;             // the du's GEMM rows per m64 pair (16 x 8 tile)
constexpr int BN = 128;                 // output channels per block
constexpr int NT = 256;                 // threads: two warpgroups
constexpr int HWD = TW + 2;             // halo width
constexpr int NUM_SMS = 132;
constexpr int SMEM_SM = 232448;         // shared memory one block may take
// modes of the engine
constexpr int SAME = 0, UP2 = 1;

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
  float* stats;       // (B, tiles, 2, Co) or null
  float* ws;          // split-K: (splits, B, Ho, Wo, Co) fp32 partial sums
  int splits, chunks_per_split;  // the engine: units (chunks) a split
  int B, H, W, C, Co, Csk, CoP;
  int tiles_w, tiles;  // pixel tiles per row of tiles / per image
};

// SiLU in fp32 with the fast exponential and division (two MUFU operations
// an element); the prologue rounds its result once to bf16.
__device__ __forceinline__ float silu_fast(float v) {
  return __fdividef(v, 1.0f + __expf(-v));
}

// The engine's forms. A block owns a pixel tile and BNW output channels and
// walks (chunk, tap) steps of DBK input channels, then the 1x1 skip's steps
// of SKB channels:
// - SAME (K1): a TH x 8 tile, TH = 16 MT; warpgroup wg takes tile rows
//   8 MT wg .. 8 MT wg + 8 MT - 1, MT m64 tiles; 9 taps a chunk, every tile
//   on the same weight tile;
// - UP2 (K4): a 16 x 8 tile of the low-resolution input and all four
//   phases of its 32 x 16 output; warpgroup wg takes tile rows 8 wg ..
//   8 wg + 7 in each phase (MT = 4), 4 taps a chunk, each phase on its own
//   weight tile (a stage holds the four).
template <int MODE, int MT_, int BNW, int DBK_, int BPS>
struct Eng {
  static constexpr bool UP = MODE == UP2;
  static constexpr int MT = MT_;                      // m64 tiles a warpgroup
  static constexpr int TH = UP ? 16 : 16 * MT;        // tile rows
  static constexpr int PIX = TH * TW;                 // tile pixels
  static constexpr int ROWS = 128 * MT;               // GEMM rows a block
  static constexpr int NPH = UP ? 4 : 1;              // weight tiles a stage
  static constexpr int T = UP ? 4 : 9;                // taps a chunk
  static constexpr int DBK = DBK_;
  static constexpr int KCH = DBK / 8;
  static constexpr int HALO_PIX = (TH + 2) * HWD;
  // entries per 8-channel group: odd in 16-byte units, so the 8 groups of
  // one pixel's 128 bytes land in distinct banks
  static constexpr int HPS = HALO_PIX + 1;
  static constexpr int HALO = KCH * HPS * 8;          // bf16 a halo buffer
  static constexpr int STAGE = NPH * KCH * BNW * 8;   // bf16 a ring stage
  // a skip step's A tile [SKB/8][ROWS][8] and B tile [SKB/8][BNW][8] share
  // a stage
  static constexpr int SKB = 64 * (ROWS + BNW) <= STAGE ? 64 : 32 * (ROWS + BNW) <= STAGE ? 32 : 16;
  static constexpr bool SKIP_OK = SKB * (ROWS + BNW) <= STAGE;
  static constexpr int FIT = (SMEM_SM / BPS - 1024 - 4 * HALO) / (2 * STAGE);
  // the next chunk's halo, issued at a chunk's tap 1, is waited for LEAD
  // steps later with the ring's own count: LEAD <= T - 2 where a pass then
  // activates it (K1), T - 1 where none does (K4)
  static constexpr int CAP = UP ? T + 1 : T;
  static constexpr int STAGES = FIT < CAP ? FIT : CAP;  // weight ring depth
  // steps loaded ahead: a stage is refilled two steps after it was read
  static constexpr int LEAD = STAGES - 2;
  static_assert(LEAD >= 1, "weight ring depth");
  static constexpr int MAIN = (2 * HALO + STAGES * STAGE) * 2;
  // the epilogue's fp32 tile [ROWS][OUT_LDF] (rows 8 banks apart, so a
  // half-warp's float2 stores of 4 rows hit 32 banks) and its stats scratch
  // [RG][2][BNW]: RG row groups of NT / RG threads, 8 channels each
  static constexpr int OUT_LDF = BNW + 8;
  static constexpr int RG = NT / (BNW / 8);
  static constexpr int EPI = ROWS * OUT_LDF * 4 + RG * 2 * BNW * 4;
  static constexpr int SMEM = MAIN > EPI ? MAIN : EPI;
  static_assert(SMEM <= SMEM_SM / BPS - 1024, "shared memory");
  // a thread's halo words: pixels tid / KCH + NT / KCH * t, channel group
  // tid % KCH (fixed); the activation pass takes them in slices over the
  // taps from 1 + LEAD on
  static_assert(NT % KCH == 0, "a thread's channel group is fixed");
  static constexpr int HWORDS = (HALO_PIX + NT / KCH - 1) / (NT / KCH);
  static constexpr int SLICES = T - 1 - LEAD > 0 ? T - 1 - LEAD : 1;
  static constexpr int PER_SLICE = (HWORDS + SLICES - 1) / SLICES;
  static_assert(!UP || MT == 4, "K4: an m64 tile a phase");
  // UP: the phase of warpgroup wg's m64 tile m, and its first tile row
  static __device__ __forceinline__ int phase(int wg, int m) { return m; }
  static __device__ __forceinline__ int prow(int wg) { return 8 * wg; }
  // GEMM row of warpgroup wg's m64 tile m: SAME rows 64 (MT wg + m) ..;
  // UP the rows of its phase's pixels from 8 prow
  static __device__ __forceinline__ int row0(int wg, int m) {
    return UP ? PIX * phase(wg, m) + 8 * prow(wg) : 64 * (MT * wg + m);
  }
};

// y = conv3x3(silu(x*a + b)) (+ skip) + bias (+ extra bias) (+ residual)
// (SAME), or the four phases of conv3x3(nearest_up2x(x)) (+ skip) + bias
// (UP2), with per-tile stats of the stored y. grid (tiles, Co / BNW,
// B x splits); a split takes units [split, split + 1) x chunks_per_split
// of the conv chunks followed by the skip's units of up to T steps.
template <int MODE, bool NORM, bool VEC, int MT_, int BNW, int DBK, int BPS>
__global__ void __launch_bounds__(NT, BPS) conv_kernel(ConvArgs p) {
  using G = Eng<MODE, MT_, BNW, DBK, BPS>;
  constexpr bool UP = G::UP;
  constexpr int MT = G::MT, T = G::T, KCH = G::KCH, HPS = G::HPS, ROWS = G::ROWS;
  constexpr int STAGES = G::STAGES, LEAD = G::LEAD, SKB = G::SKB;
  // the next chunk's halo (issued at tap 1) lands LEAD steps later, and is
  // then activated in place before the chunk's first step
  static_assert(!VEC || LEAD <= T - (NORM ? 2 : 1), "halo lead");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* halo = reinterpret_cast<bf16*>(smem);     // 2 x [KCH][HPS][8]
  bf16* ring = halo + 2 * G::HALO;                // STAGES x stage
  float* acc_s = reinterpret_cast<float*>(smem);  // epilogue: [ROWS][OUT_LDF]
  float* red = acc_s + ROWS * G::OUT_LDF;         // [RG][2][BNW]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7, wq = warp & 3;
  const int b = blockIdx.z % p.B, split = blockIdx.z / p.B;
  const int i0 = (blockIdx.x / p.tiles_w) * G::TH, j0 = (blockIdx.x % p.tiles_w) * TW;
  const int n0 = blockIdx.y * BNW;
  const int Ho = UP ? 2 * p.H : p.H, Wo = UP ? 2 * p.W : p.W;
  const int KC = (p.C + DBK - 1) / DBK;      // conv chunks
  const int KSS = (p.Csk + SKB - 1) / SKB;   // skip steps
  const int ubeg = split * p.chunks_per_split, uend = ubeg + p.chunks_per_split;
  const int kc0 = min(ubeg, KC), kc1 = min(uend, KC);
  const int ss0 = min(max(ubeg - KC, 0) * T, KSS), ss1 = min(max(uend - KC, 0) * T, KSS);
  const int nconv = (kc1 - kc0) * T;
  const int nsteps = nconv + ss1 - ss0;
  const int C8 = (p.C + 7) / 8, Csk8 = (p.Csk + 7) / 8;

  // GEMM row r of the tile -> its output pixel (ho, wo); false outside
  auto row_pix = [&](int r, int& ho, int& wo) {
    const int q = r % G::PIX, i = i0 + q / TW, j = j0 + q % TW;
    ho = UP ? 2 * i + (r / G::PIX >> 1) : i;
    wo = UP ? 2 * j + (r / G::PIX & 1) : j;
    return i < p.H && j < p.W;
  };

  // ---- the halo of chunk k: [KCH][HPS][8]. A thread's words are pixels
  // tid / KCH + NT / KCH * t of channel group skc. With C a multiple of 8
  // they go from device memory to shared memory raw by cp.async,
  // zero-filled outside the image and past C, and a later pass applies
  // the GroupNorm affine + SiLU in place (zero outside the image after
  // activation; past C a = b = 0 and x = 0, and silu(0) = 0). Otherwise
  // (the conv_ins' C = 3, 4) by element through registers, activated on
  // the way.
  const int skc = tid % KCH;
  float sa[8], sb[8];
  auto load_ab = [&](int k) {
    const int c = k * DBK + skc * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool ok = c + e < p.C;
      sa[e] = ok ? p.ga[(size_t)b * p.C + c + e] : 0.f;
      sb[e] = ok ? p.gb[(size_t)b * p.C + c + e] : 0.f;
    }
  };
  auto in_image = [&](int pix) {
    const int hr = pix / HWD, ih = i0 - 1 + hr, iw = j0 - 1 + pix - hr * HWD;
    return ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
  };
  auto issue_halo = [&](int k, int buf) {
    bf16* hb = halo + buf * G::HALO + skc * HPS * 8;
    const int c = k * DBK + skc * 8;
    if constexpr (NORM && !VEC) load_ab(k);
#pragma unroll 2
    for (int pix = tid / KCH; pix < G::HALO_PIX; pix += NT / KCH) {
      const int hr = pix / HWD, ih = i0 - 1 + hr, iw = j0 - 1 + pix - hr * HWD;
      const bool in = ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
      const bf16* src = p.x + (((size_t)b * p.H + ih) * p.W + iw) * p.C + c;
      if constexpr (VEC) {
        const bool ok = in && c < p.C;
        cp_async16(hb + pix * 8, ok ? src : p.x, ok);
      } else {
        Pack8 v;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float f = in && c + e < p.C ? __bfloat162float(src[e]) : 0.f;
          if constexpr (NORM) f = in ? silu_fast(f * sa[e] + sb[e]) : 0.f;
          v.h[e] = __float2bfloat16(f);
        }
        *reinterpret_cast<Pack8*>(hb + pix * 8) = v;
      }
    }
  };
  // slice sl of the activation pass over a raw halo that has landed
  auto activate = [&](int buf, int sl) {
    bf16* hb = halo + buf * G::HALO + skc * HPS * 8;
#pragma unroll
    for (int t = sl * G::PER_SLICE; t < (sl + 1) * G::PER_SLICE && t < G::HWORDS; ++t) {
      const int pix = tid / KCH + NT / KCH * t;
      if (pix >= G::HALO_PIX) break;
      Pack8 v = *reinterpret_cast<const Pack8*>(hb + pix * 8);
      const bool in = in_image(pix);
      __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(v.h);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(v2[e]);
        v2[e] = in ? __floats2bfloat162_rn(silu_fast(f.x * sa[2 * e] + sb[2 * e]),
                                           silu_fast(f.y * sa[2 * e + 1] + sb[2 * e + 1]))
                   : __floats2bfloat162_rn(0.f, 0.f);
      }
      *reinterpret_cast<Pack8*>(hb + pix * 8) = v;
    }
  };
  constexpr bool PASS = NORM && VEC;  // the activation pass runs

  // ---- step i's ring stage: a conv step's weight tiles [NPH][KCH][BNW][8]
  // (phase ph of K4 reads packed taps 4 ph .. 4 ph + 3), or a skip step's
  // tile of skip_x [SKB/8][ROWS][8] and its weights [SKB/8][BNW][8], by
  // cp.async in the step's group
  auto load_stage = [&](int i) {
    bf16* st = ring + (i % STAGES) * G::STAGE;
    if (i < nconv) {
      const int kk = i / T, tap = i - kk * T, c8 = (kc0 + kk) * KCH;
#pragma unroll
      for (int t = 0; t < G::STAGE / 8 / NT; ++t) {
        const int q = tid + NT * t;
        const int ph = q / (KCH * BNW), kc = q / BNW % KCH, n = q % BNW;
        const bool ok = c8 + kc < C8 && n0 + n < p.CoP;
        const bf16* src =
            p.w + ((size_t)((UP ? 4 * ph + tap : tap) * C8 + c8 + kc) * p.CoP + n0 + n) * 8;
        cp_async16(st + q * 8, ok ? src : p.w, ok);
      }
    } else {
      const int c8 = (ss0 + i - nconv) * (SKB / 8);
      for (int q = tid; q < SKB / 8 * ROWS; q += NT) {
        const int kc = q / ROWS, r = q % ROWS;
        int ho, wo;
        const bool ok = row_pix(r, ho, wo) && c8 + kc < Csk8;
        const bf16* src = p.skx + (((size_t)b * Ho + ho) * Wo + wo) * p.Csk + (c8 + kc) * 8;
        cp_async16(st + q * 8, ok ? src : p.skx, ok);
      }
      bf16* sw = st + SKB / 8 * ROWS * 8;
      for (int q = tid; q < SKB / 8 * BNW; q += NT) {
        const int kc = q / BNW, n = q % BNW;
        const bool ok = c8 + kc < Csk8 && n0 + n < p.CoP;
        cp_async16(sw + q * 8, ok ? p.skw + ((size_t)(c8 + kc) * p.CoP + n0 + n) * 8 : p.skw, ok);
      }
    }
  };

  // the first chunk's halo (in group 0) and LEAD stages; a raw halo is
  // activated once it has landed
  if (nconv > 0) {
    if constexpr (PASS) load_ab(kc0);
    issue_halo(kc0, 0);
  }
#pragma unroll
  for (int s = 0; s < LEAD; ++s) {
    if (s < nsteps) load_stage(s);
    cp_async_commit();  // group s: step s's stage
  }
  if constexpr (PASS) {
    if (nconv > 0) {
      cp_async_wait<LEAD - 1>();
      __syncthreads();
#pragma unroll
      for (int sl = 0; sl < G::SLICES; ++sl) activate(0, sl);
    }
  }

  float d[MT][BNW / 2];
  for (int i = 0; i < nsteps; ++i) {
    const int kk = i / T, tap = i - kk * T;
    // step i's stage (group i) and every halo issued LEAD steps back have
    // landed, and every thread's activation stores are visible; step i-2's
    // wgmmas have retired in every warpgroup
    cp_async_wait<LEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    if (i + LEAD < nsteps) load_stage(i + LEAD);
    // the next chunk's halo into the other buffer (free from tap 1: chunk
    // kk-1's last step was i-2 there), in this step's group
    const bool next = i < nconv && kc0 + kk + 1 < kc1;
    if (next && tap == 1) {
      if constexpr (PASS) load_ab(kc0 + kk + 1);
      issue_halo(kc0 + kk + 1, (kk + 1) & 1);
    }
    cp_async_commit();
    const bf16* st = ring + (i % STAGES) * G::STAGE;
#pragma unroll
    for (int m = 0; m < MT; ++m) i2i::reg_fence(d[m]);
    i2i::wgmma_fence();
    if (i < nconv) {
      // an m64 tile's 8 tile rows for this tap: 8 core matrices one halo
      // row apart; K steps of 16 channels two channel groups apart
      const bf16* hb = halo + (kk & 1) * G::HALO;
#pragma unroll
      for (int ks = 0; ks < DBK / 16; ++ks) {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          int di, dj;
          const bf16* bt = st + 2 * ks * BNW * 8;
          if constexpr (UP) {  // phase (ph / 2, ph % 2), tap (tap / 2, tap % 2)
            const int ph = G::phase(wg, m);
            di = G::prow(wg) + (ph >> 1) + (tap >> 1);
            dj = (ph & 1) + (tap & 1);
            bt += ph * KCH * BNW * 8;
          } else {
            di = 8 * (MT * wg + m) + tap / 3;
            dj = tap % 3;
          }
          const uint64_t da = smem_desc(hb + ((di * HWD + dj) + 2 * ks * HPS) * 8, HPS * 16, HWD * 16);
          const uint64_t db = smem_desc(bt, BNW * 16, 128);
          if constexpr (BNW == 128)
            i2i::wgmma_m64n128k16_ss(d[m], da, db, i > 0 || ks > 0);
          else if constexpr (BNW == 64)
            i2i::wgmma_m64n64k16_ss(d[m], da, db, i > 0 || ks > 0);
          else
            i2i::wgmma_m64n32k16_ss(d[m], da, db, i > 0 || ks > 0);
        }
      }
    } else {
      const bf16* sw = st + SKB / 8 * ROWS * 8;
#pragma unroll
      for (int ks = 0; ks < SKB / 16; ++ks) {
        const uint64_t db = smem_desc(sw + 2 * ks * BNW * 8, BNW * 16, 128);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint64_t da =
              smem_desc(st + (G::row0(wg, m) + 2 * ks * ROWS) * 8, ROWS * 16, 128);
          if constexpr (BNW == 128)
            i2i::wgmma_m64n128k16_ss(d[m], da, db, i > 0 || ks > 0);
          else if constexpr (BNW == 64)
            i2i::wgmma_m64n64k16_ss(d[m], da, db, i > 0 || ks > 0);
          else
            i2i::wgmma_m64n32k16_ss(d[m], da, db, i > 0 || ks > 0);
        }
      }
    }
    i2i::wgmma_commit();
    // a slice of the next chunk's activation while the group runs, once
    // its raw halo has landed (taps 1 + LEAD .. T - 1)
    if constexpr (PASS) {
      if (next && tap > LEAD) activate((kk + 1) & 1, tap - 1 - LEAD);
    }
    i2i::wgmma_wait<1>();
#pragma unroll
    for (int m = 0; m < MT; ++m) i2i::reg_fence(d[m]);
  }
  i2i::wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < MT; ++m) i2i::reg_fence(d[m]);
  cp_async_wait<0>();

  // ---- epilogue: the fp32 tile into shared memory (over the halos and the
  // ring, free once every group retired). Register 4j+2h+e of d[m] in
  // thread (warp wq of the warpgroup, lane l) holds GEMM row row0(wg, m) +
  // 16 wq + l/4 + 8h, channel n0 + 8j + 2(l%4) + e.
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = G::row0(wg, m) + 16 * wq + (lane >> 2) + 8 * h;
#pragma unroll
      for (int j = 0; j < BNW / 8; ++j)
        *reinterpret_cast<float2*>(acc_s + r * G::OUT_LDF + 8 * j + 2 * (lane & 3)) =
            make_float2(d[m][4 * j + 2 * h], d[m][4 * j + 2 * h + 1]);
    }
  }
  __syncthreads();
  // a thread takes 8 channels (group cg) of every RG-th row: bias, extra
  // bias and residual added in fp32 (16-byte reads), one rounding, one
  // 16-byte store of y, and the stats of the rounded values; a split writes
  // its fp32 partial sums instead
  const int cg = tid % (BNW / 8), rg = tid / (BNW / 8), n = n0 + 8 * cg;
  const bool vec_out = p.Co % 8 == 0;
  float bv[8], ev[8], s1[8], s2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const bool ok = n + e < p.Co;
    bv[e] = ok && p.bias ? p.bias[n + e] : 0.f;
    ev[e] = ok && p.eb ? p.eb[(size_t)b * p.Co + n + e] : 0.f;
    s1[e] = s2[e] = 0.f;
  }
  // the thread's residual rows first, all in flight at once
  constexpr int RPT = ROWS / G::RG;  // rows a thread
  Pack8 rv[RPT];
#pragma unroll
  for (int t = 0; t < RPT; ++t) {
    int ho, wo;
    rv[t] = i2i::zero8();
    if (!p.res || p.splits > 1 || !row_pix(rg + G::RG * t, ho, wo) || n >= p.Co) continue;
    const bf16* src = p.res + (((size_t)b * Ho + ho) * Wo + wo) * p.Co + n;
    if (vec_out) {
      rv[t] = *reinterpret_cast<const Pack8*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (n + e < p.Co) rv[t].h[e] = src[e];
    }
  }
#pragma unroll
  for (int t_ = 0; t_ < RPT; ++t_) {
    const int r = rg + G::RG * t_;
    int ho, wo;
    if (!row_pix(r, ho, wo) || n >= p.Co) continue;
    const float4 a0 = *reinterpret_cast<const float4*>(acc_s + r * G::OUT_LDF + 8 * cg);
    const float4 a1 = *reinterpret_cast<const float4*>(acc_s + r * G::OUT_LDF + 8 * cg + 4);
    float v[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const size_t o = (((size_t)b * Ho + ho) * Wo + wo) * p.Co + n;
    if (p.splits > 1) {
      float* dst = p.ws + (size_t)split * p.B * Ho * Wo * p.Co + o;
      if (vec_out) {
        *reinterpret_cast<float4*>(dst) = a0;
        *reinterpret_cast<float4*>(dst + 4) = a1;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (n + e < p.Co) dst[e] = v[e];
      }
      continue;
    }
    Pack8 yv;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float t = v[e] + bv[e];
      if (p.eb) t += ev[e];
      if (p.res) t += __bfloat162float(rv[t_].h[e]);
      yv.h[e] = __float2bfloat16(t);
      const float f = n + e < p.Co ? __bfloat162float(yv.h[e]) : 0.f;
      s1[e] += f;
      s2[e] += f * f;
    }
    if (vec_out) {
      *reinterpret_cast<Pack8*>(p.y + o) = yv;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (n + e < p.Co) p.y[o + e] = yv.h[e];
    }
  }
  if (p.stats && p.splits == 1) {
    // the row groups added in a fixed order: no atomics
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red[(rg * 2 + 0) * BNW + 8 * cg + e] = s1[e];
      red[(rg * 2 + 1) * BNW + 8 * cg + e] = s2[e];
    }
    __syncthreads();
    if (tid < BNW && n0 + tid < p.Co) {
      float t1 = 0.f, t2 = 0.f;
      for (int g = 0; g < G::RG; ++g) {
        t1 += red[(g * 2 + 0) * BNW + tid];
        t2 += red[(g * 2 + 1) * BNW + tid];
      }
      float* st = p.stats + ((size_t)b * p.tiles + blockIdx.x) * 2 * p.Co;
      st[n0 + tid] = t1;
      st[p.Co + n0 + tid] = t2;
    }
  }
}

// The engine's split-K second pass, one block per (pixel tile, 64 channels,
// image): each thread adds one pixel's 8 channels over the splits in split
// order (32-byte loads), adds bias, extra bias and residual, rounds once
// and writes them in one 16-byte store, for every 32nd pixel of the tile;
// the tile's stats of the rounded values are then summed over the 32 pixel
// slots in a fixed order.
template <int MODE, int TH>
__global__ void __launch_bounds__(NT) conv_reduce(ConvArgs p) {
  constexpr bool UP = MODE == UP2;
  constexpr int ROWS = (UP ? 4 : 1) * TH * TW;  // K4: four phases of the tile
  __shared__ float rs[2][NT][8];
  const int tid = threadIdx.x, g = tid & 7, slot = tid >> 3;
  const int b = blockIdx.z, tile = blockIdx.x;
  const int i0 = (tile / p.tiles_w) * TH, j0 = (tile % p.tiles_w) * TW;
  const int Ho = UP ? 2 * p.H : p.H, Wo = UP ? 2 * p.W : p.W;
  const int c0 = blockIdx.y * 64 + 8 * g;
  const size_t stride = (size_t)p.B * Ho * Wo * p.Co;
  const bool vec = p.Co % 8 == 0;
  float s1[8], s2[8], bb[8], eb[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const bool ok = c0 + e < p.Co;
    s1[e] = s2[e] = 0.f;
    bb[e] = ok && p.bias ? p.bias[c0 + e] : 0.f;
    eb[e] = ok && p.eb ? p.eb[(size_t)b * p.Co + c0 + e] : 0.f;
  }
  for (int r = slot; r < ROWS && c0 < p.Co; r += NT / 8) {
    const int q = r % (TH * TW), ph = r / (TH * TW);
    const int i = i0 + q / TW, j = j0 + q % TW;
    const int ho = UP ? 2 * i + (ph >> 1) : i, wo = UP ? 2 * j + (ph & 1) : j;
    if (i >= p.H || j >= p.W) continue;
    const size_t o = (((size_t)b * Ho + ho) * Wo + wo) * p.Co + c0;
    const float* src = p.ws + o;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    Pack8 rv = i2i::zero8();
    if (vec) {
#pragma unroll 4
      for (int sp = 0; sp < p.splits; ++sp) {
        const float4 a = *reinterpret_cast<const float4*>(src + sp * stride);
        const float4 c = *reinterpret_cast<const float4*>(src + sp * stride + 4);
        v[0] += a.x; v[1] += a.y; v[2] += a.z; v[3] += a.w;
        v[4] += c.x; v[5] += c.y; v[6] += c.z; v[7] += c.w;
      }
      if (p.res) rv = *reinterpret_cast<const Pack8*>(p.res + o);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (c0 + e >= p.Co) continue;
        for (int sp = 0; sp < p.splits; ++sp) v[e] += src[sp * stride + e];
        if (p.res) rv.h[e] = p.res[o + e];
      }
    }
    Pack8 yv;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float t = v[e] + bb[e];
      if (p.eb) t += eb[e];
      if (p.res) t += __bfloat162float(rv.h[e]);
      yv.h[e] = __float2bfloat16(t);
      const float f = c0 + e < p.Co ? __bfloat162float(yv.h[e]) : 0.f;
      s1[e] += f;
      s2[e] += f * f;
    }
    bf16* dst = p.y + o;
    if (vec) {
      *reinterpret_cast<Pack8*>(dst) = yv;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (c0 + e < p.Co) dst[e] = yv.h[e];
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

// The engine's form for a call (K1 and K4): its tile rows (th: a th x 8
// pixel tile, of the low-resolution input for K4), output channels a block
// (bn), channels a conv step (dbk), blocks an SM (bps), blocks before any
// split, and its split over the units (conv chunks, then the skip's steps
// in units of up to T).
enum ConvKind { K_T16, K_SMALLN32, K_SMALLN16, K_ELEM, K_UP };

struct ConvForm {
  ConvKind kind;
  int th, bn, dbk, bps, skb, stages;
  long blocks;
  Plan pl;
};

template <int MODE, int MT, int BNW, int DBK, int BPS>
ConvForm conv_form_of(ConvKind kind, int B, int H, int W, int C, int Co, int Csk) {
  using G = Eng<MODE, MT, BNW, DBK, BPS>;
  ConvForm f{kind, G::TH, BNW, DBK, BPS, G::SKB, G::STAGES, 0, {}};
  f.blocks = (long)((H + G::TH - 1) / G::TH) * ((W + TW - 1) / TW) * B * ((Co + BNW - 1) / BNW);
  const int units = (C + DBK - 1) / DBK + ((Csk + G::SKB - 1) / G::SKB + G::T - 1) / G::T;
  f.pl = split_plan(f.blocks, units, NUM_SMS * BPS, 16);
  return f;
}

// K4: the 16 x 8 four-phase tile. C not a multiple of 8 (the conv_ins' C =
// 3, 4): 16-channel steps. Co <= 32 with no skip (the conv_outs): the
// small-N form, 32 channels a block, on the 32 x 8 tile where its grid
// fills four rounds of blocks, else on the 16 x 8 one (twice the blocks).
// Otherwise the 16 x 8 tile at two blocks an SM: a 32 x 8 tile at one an
// SM, and the 16 x 8 at one an SM with a deeper ring or 128-channel steps,
// measured slower at every path shape (tools/k1_variants.py). Each form
// splits its chunks where its grid is under one wave (split_plan).
ConvForm conv_form(int B, int H, int W, int C, int Co, int Csk, bool up) {
  if (up) return conv_form_of<UP2, 4, 64, 64, 1>(K_UP, B, H, W, C, Co, Csk);
  if (C % 8) return conv_form_of<SAME, 1, 128, 16, 2>(K_ELEM, B, H, W, C, Co, Csk);
  if (Co <= 32 && Csk == 0) {
    const ConvForm f = conv_form_of<SAME, 2, 32, 64, 2>(K_SMALLN32, B, H, W, C, Co, Csk);
    return f.blocks >= 4 * NUM_SMS ? f
                                   : conv_form_of<SAME, 1, 32, 64, 2>(K_SMALLN16, B, H, W, C, Co, Csk);
  }
  return conv_form_of<SAME, 1, 128, 64, 2>(K_T16, B, H, W, C, Co, Csk);
}

template <int MODE, bool NORM, bool VEC, int MT, int BNW, int DBK, int BPS>
int launch_conv(ConvArgs a, cudaStream_t stream) {
  using G = Eng<MODE, MT, BNW, DBK, BPS>;
  if (a.Csk > 0 && !G::SKIP_OK) return (int)cudaErrorInvalidValue;
  auto kernel = conv_kernel<MODE, NORM, VEC, MT, BNW, DBK, BPS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.tiles, (a.Co + BNW - 1) / BNW, a.B * a.splits);
  kernel<<<grid, NT, G::SMEM, stream>>>(a);
  if (a.splits > 1)
    conv_reduce<MODE, G::TH><<<dim3(a.tiles, (a.Co + 63) / 64, a.B), NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool NORM>
int launch_same(const ConvForm& f, const ConvArgs& a, cudaStream_t s) {
  switch (f.kind) {
    case K_T16: return launch_conv<SAME, NORM, true, 1, 128, 64, 2>(a, s);
    case K_SMALLN32: return launch_conv<SAME, NORM, true, 2, 32, 64, 2>(a, s);
    case K_SMALLN16: return launch_conv<SAME, NORM, true, 1, 32, 64, 2>(a, s);
    case K_ELEM: return launch_conv<SAME, NORM, false, 1, 128, 16, 2>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
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

// The engine's pixel tiles per image for a call, the stats' second
// dimension: the output in tiles of the call's form (for K4 a tile of the
// low-resolution input, all four phases of its output).
int conv_stats_tiles(int B, int H, int W, int C, int Co, int Csk, int up) {
  const ConvForm f = conv_form(B, H, W, C, Co, Csk, up);
  return ((H + f.th - 1) / f.th) * ((W + TW - 1) / TW);
}

// Bytes of fp32 split-K workspace conv3x3_bf16 needs for this call (0 when
// the call does not split).
long conv_workspace_bytes(int B, int H, int W, int C, int Co, int Csk, int up) {
  const Plan pl = conv_form(B, H, W, C, Co, Csk, up).pl;
  if (pl.splits == 1) return 0;
  return (long)pl.splits * B * (up ? 4 : 1) * H * W * Co * 4;
}

// The engine's launch form for a call: out[0] tile rows (an out[0] x 8
// tile, of the low-resolution input for K4), out[1] output channels a
// block, out[2] channels a conv step, out[3] channels a skip step, out[4]
// blocks an SM, out[5] weight ring stages, out[6] splits, out[7] units (a
// chunk's taps, or up to as many skip steps) a split, out[8] blocks
// launched.
void conv_plan(int B, int H, int W, int C, int Co, int Csk, int up, int* out) {
  const ConvForm f = conv_form(B, H, W, C, Co, Csk, up);
  out[0] = f.th;
  out[1] = f.bn;
  out[2] = f.dbk;
  out[3] = f.skb;
  out[4] = f.bps;
  out[5] = f.stages;
  out[6] = f.pl.splits;
  out[7] = f.pl.chunks_per_split;
  out[8] = (int)(f.blocks * f.pl.splits);
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
// (2,2,2,2,C,Co), and the GroupNorm prologue, extra bias and residual are
// not taken. Packed weights are (taps, ceil(C/8), ceil(Co/8)*8, 8) bf16.
// Pointers that an option does not use are null; Csk must be a multiple of
// 8, and with C not a multiple of 8 there is no skip (K4: C a multiple of
// 8); stats (B, conv_stats_tiles(...), 2, Co); workspace holds
// conv_workspace_bytes() bytes (null when that is 0). Returns the first
// CUDA error of the launches, else 0.
int conv3x3_bf16(const void* x, const void* w, const void* bias, const void* ga,
                 const void* gb, const void* eb, const void* res, const void* skx,
                 const void* skw, void* y, void* stats, void* workspace, int B,
                 int H, int W, int C, int Co, int Csk, int up, void* stream) {
  ConvArgs a = {};
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
  if (a.Csk % 8 || (a.Csk && C % 8) || (up && (C % 8 || ga || eb || res)))
    return (int)cudaErrorInvalidValue;
  const ConvForm f = conv_form(B, H, W, C, Co, a.Csk, up);
  a.tiles_w = (W + TW - 1) / TW;
  a.tiles = ((H + f.th - 1) / f.th) * a.tiles_w;
  a.splits = f.pl.splits;
  a.chunks_per_split = f.pl.chunks_per_split;
  a.ws = static_cast<float*>(workspace);
  if (a.splits > 1 && !workspace) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (up) return launch_conv<UP2, false, true, 4, 64, 64, 1>(a, s);
  return ga ? launch_same<true>(f, a, s) : launch_same<false>(f, a, s);
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
