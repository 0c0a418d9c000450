// The pair layout's tensor-core body for sm_90a: a W4A16 GEMM over
// pair-layout 4-bit weights with a cp.async ring and the weights decoded
// in registers, straight into the mma.sync B fragments. Two kernels run it
// through one entry point, qt_pair_mma:
//  - K8, the prefill pair kernel: replaces
//    quantizations_tpu/ops/qmatmul.py:755 _pair_prefill_kernel, reached
//    through matmul_4bit_pair_prefill_pallas (:837) and
//    matmul_4bit_pair_prefill_pallas_stacked (:891);
//  - K1 from 129 token rows on (ops/qmatmul.py PAIR_MMA_MIN_TOKENS): the
//    function of quantizations_tpu/ops/qmatmul.py:481 _pair_kernel
//    (matmul_4bit_pair_pallas :588, matmul_4bit_pair_pallas_stacked :662),
//    whose CUDA-core body (csrc/pair_matmul.cu) keeps the rows below.
// The stacked forms pass a pointer to layer idx.
//
//   y[t, m] = sum_k bf16(x[t, k]) * W[m, k]          (fp32 accumulation)
//   W[m, k] = bf16(table[code(m, k)] * s_bf)          (__hmul2, RNE)
//   s_bf    = bf16(scale[m, k / 64]), then bf16(s_bf * bf16(out_factor))
//
// K1's rounding class (csrc/pair_matmul.cu): the same weights and
// activations, fp32 sums in another order (the tensor cores').
//
// Bound: the operations. At T = 512 the 128 projections of a Llama3-8B
// forward are 7.15 TFLOP, 7.23 ms at the 989 TFLOP/s of the bf16 tensor
// cores, against 2.3 ms for their bytes; at T = 256 3.6 TFLOP, 3.6 ms.
// mma.sync reaches a part of that rate only if the decode and the loads
// stay off its path. The design:
//  - a block owns BM weight rows (BM / 2 row pairs) x BN tokens, tiles
//    from the host's rule (ops/qmatmul.py pair_mma_tiles: BN = 128 from
//    128 tokens on, so a weight is decoded T / 128 times; BM = 64, the
//    fastest of the three row tiles built here when measured); each warp
//    owns 16 rows (8 row pairs: one n8 tile of their even rows, one of
//    their odd rows) x 64 tokens (four m16 tiles), 32 running sums and
//    32 block partials a lane (a 32-row warp tile took 253 registers and
//    left one or two warps per scheduler);
//  - K goes in 64-column steps (one scale block) through a ring of
//    kStages stages in shared memory holding the tile's scales for the
//    block (4-byte cp.async) and the bf16 activation tile (16-byte
//    cp.async, rows padded to 72 values so that ldmatrix reads them
//    without bank conflicts; missing tokens zero-filled). Step
//    k + kStages - 1's copies are in flight while step k computes, with
//    one barrier per step;
//  - the raw pair words come 4 steps at a time into two slots: a row
//    pair's 16 words of one scale block lie NB words apart, in 16
//    different cache lines, but its words of 4 consecutive blocks are
//    one 16-byte segment, copied by 4 neighbouring threads. A line is so
//    touched once per 4 steps, not once per step (on an H100, 12%
//    faster at T = 256 than a per-step copy of single words);
//  - the activation tile stays in ORIGINAL column order (ldmatrix.x4 A
//    fragments, no permuted copy of x): of the m16n8k16 B fragment, lane
//    (g, tg) holds columns 2tg, 2tg + 1 and 2tg + 8, 2tg + 9 of row g,
//    and in original order the columns 16s + 2tg, +1 sit in one nibble
//    pair of the word (row pair g, half tg / 2, r = 2s), the columns
//    16s + 8 + 2tg, +1 in the word r = 2s + 1. So each lane decodes its
//    own fragments from two words, for two n8 tiles at once: the even
//    rows of 8 row pairs from the low nibbles of each half-word, the odd
//    rows from the high ones. No bf16 weight tile, no second barrier.
//    (The TPU kernel permutes x to the words' order instead; the
//    original order saves that pass and costs one more 4-byte read per
//    lane, the second word);
//  - decode: the 16-entry bf16 table in shared memory (all of it in 8
//    banks: conflict-free), the scale rounded to bf16 and multiplied by
//    bf16(out_factor) once per block, then __hmul2: K1's rounding points;
//  - two-level sums: the tensor cores chain their fp32 additions over
//    one 64-column block only (a fragment started at zero), and each
//    block's partial sum is added to the running total with an ordinary
//    round-to-nearest fp32 add, so the error does not grow with K's 224
//    blocks at K = 14336 as one chained accumulator's would;
//  - the epilogue writes the even and odd row of a pair as one float2.
// Any T >= 1 and any even M: token and row tails are zero-filled and
// masked. mma.sync only: no wgmma, TMA, clusters or persistent blocks.
// nvcc -Xptxas -v (sm_90a, CUDA 12.8), registers per tile (bm, bn):
// (32, 64) 168, (64, 64) 144, (128, 64) 128, (32, 128) 144, (64, 128)
// 128, (128, 128) 128; no spills; 32 bytes of static shared memory and
// 304 bm + kStages * (4 bm + 144 bn) bytes of dynamic (at the rule's
// (64, 128): 75,520 bytes, two blocks an SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 3;     // cp.async ring depth, in 64-column K steps
constexpr int kWarpM = 16;     // weight rows per warp (8 row pairs)
constexpr int kWarpT = 64;     // tokens per warp (4 m16 tiles)
constexpr int kLdx = 64 + 8;   // padded activation row, in bf16

// The words come 4 K steps at a time (a "word step"): of row pair i, half
// h, word r, the 4 consecutive words of steps 4j..4j+3, one 16-byte
// segment, copied by 4 neighbouring threads. Two word-step slots; in a
// slot, row pair i at i * kPairW, its half h at h * 40, step 4j + bb at
// bb * 8, word r at r: a lane's 8 words of a step are 2 aligned uint4
// and the 8 lanes of a quarter-warp read 4 disjoint bank groups.
constexpr int kWordSteps = 4;
constexpr int kPairW = 76;     // words per row pair in a slot (72 + pad)

template <int BM, int BN>
struct Tile {
  static constexpr int kWarpsM = BM / kWarpM;
  static constexpr int kThreads = 32 * kWarpsM * (BN / kWarpT);
  static constexpr int kWords = BM / 2 * kPairW;   // uint32 per word slot
  static constexpr int kScales = BM;               // uint32 per stage
  static constexpr int kX = BN * kLdx;             // bf16 per stage
  static constexpr size_t kSmem =
      2 * (size_t)kWords * 4 +
      kStages * ((size_t)kScales * 4 + (size_t)kX * 2);
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ __nv_bfloat16 bf16_from_bits(uint32_t bits) {
  __nv_bfloat16_raw r;
  r.x = static_cast<unsigned short>(bits & 0xFFFFu);
  return __nv_bfloat16(r);
}

// Two bf16 weights from the nibbles at bits sh and sh + 4 of w (the first
// in the low half), each bf16(table[code] * s).
__device__ __forceinline__ uint32_t decode2(const __nv_bfloat16* tbl,
                                            uint32_t w, int sh,
                                            __nv_bfloat162 s2) {
  const __nv_bfloat162 v = __hmul2(
      __halves2bfloat162(tbl[(w >> sh) & 15u], tbl[(w >> (sh + 4)) & 15u]),
      s2);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Word step j's copies into a slot: of BM / 2 row pairs, the words of
// steps 4j..4j+3 (zero past NB or M2). Thread q takes step bb = q & 3 of
// word r, half h, row pair q >> 6: 4 threads read 16 contiguous bytes.
template <int BM, int BN>
__device__ __forceinline__ void copy_words(
    uint32_t* slot, const int32_t* __restrict__ wp2, int j, int p0, int M2,
    int K4, int NB) {
  using TL = Tile<BM, BN>;
  const int K8 = K4 / 2;
  for (int q = threadIdx.x; q < BM / 2 * 64; q += TL::kThreads) {
    const int bb = q & 3, r = (q >> 2) & 7, h = (q >> 5) & 1;
    const int i = p0 + (q >> 6), b = kWordSteps * j + bb;
    const bool ok = i < M2 && b < NB;
    cp_async4(slot + (q >> 6) * kPairW + h * 40 + bb * 8 + r,
              wp2 + (ok ? (size_t)i * K4 + h * K8 + r * NB + b : 0), ok);
  }
}

// One K step's other copies into a stage: the scales of the tile's rows
// for block b and x's 64 columns of block b for BN tokens. scale_kind: 0 =
// fp32 [M, NB], 1 = bf16 [M, NB] (the aligned 4-byte pair holding (m, b)
// when bf16_pairs, else the value itself, stored synchronously), 2 =
// bf16x2 int32 [M/2, NB].
template <int BM, int BN>
__device__ __forceinline__ void copy_step(
    uint32_t* sst, __nv_bfloat16* xst, const void* __restrict__ scales,
    int kind, int bf16_pairs, const __nv_bfloat16* __restrict__ x, int b,
    int p0, int t0, int T, int M2, int K4, int NB) {
  using TL = Tile<BM, BN>;
  const int K = 4 * K4;
  if (kind == 2) {
    const int32_t* s = static_cast<const int32_t*>(scales);
    for (int q = threadIdx.x; q < BM / 2; q += TL::kThreads) {
      const bool ok = p0 + q < M2;
      cp_async4(sst + q, s + (ok ? (size_t)(p0 + q) * NB + b : 0), ok);
    }
  } else if (kind == 0 || bf16_pairs) {
    for (int q = threadIdx.x; q < BM; q += TL::kThreads) {
      const int m = 2 * p0 + q;
      const bool ok = m < 2 * M2;
      const void* src =
          kind == 0
              ? static_cast<const void*>(static_cast<const float*>(scales) +
                                         (ok ? (size_t)m * NB + b : 0))
              : static_cast<const void*>(
                    static_cast<const __nv_bfloat16*>(scales) +
                    (ok ? (size_t)m * NB + (b & ~1) : 0));
      cp_async4(sst + q, src, ok);
    }
  } else {
    const unsigned short* s = static_cast<const unsigned short*>(scales);
    for (int q = threadIdx.x; q < BM; q += TL::kThreads) {
      const int m = 2 * p0 + q;
      sst[q] = m < 2 * M2 ? __ldg(s + (size_t)m * NB + b) : 0u;
    }
  }
  for (int q = threadIdx.x; q < BN * 8; q += TL::kThreads) {
    const int t = q >> 3, c = q & 7;
    const bool ok = t0 + t < T;
    cp_async16(xst + t * kLdx + 8 * c,
               x + (ok ? (size_t)(t0 + t) * K + 64 * b + 8 * c : 0), ok);
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(Tile<BM, BN>::kThreads)
pair_mma_kernel(const int32_t* __restrict__ wp2,
                const void* __restrict__ scales, int scale_kind,
                int bf16_pairs, const __nv_bfloat16* __restrict__ table,
                const __nv_bfloat16* __restrict__ x, float* __restrict__ y,
                int T, int M2, int K4, int has_factor, float factor) {
  using TL = Tile<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  uint32_t* scl = words + 2 * TL::kWords;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(
      scl + kStages * TL::kScales);
  __shared__ __nv_bfloat16 tbl[16];

  const int NB = K4 / 16;
  const int M = 2 * M2;
  const int t0 = blockIdx.x * BN;
  const int p0 = blockIdx.y * (BM / 2);          // first row pair
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;        // mma fragment coordinates
  const int wm = warp % TL::kWarpsM, wt = warp / TL::kWarpsM;
  const int sh = 8 * (tg & 1);                   // the lane's nibble pair
  const int half = tg >> 1;                      // and its half-word row
  const __nv_bfloat16 fac = __float2bfloat16_rn(factor);

  if (threadIdx.x < 16) tbl[threadIdx.x] = table[threadIdx.x];

  // acc[a][n]: m16 tile a (16 tokens) x n8 tile n = 0 (the even rows of
  // the warp's 8 row pairs) or 1 (their odd rows)
  float acc[4][2][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][n][c] = 0.f;

  // word step 0 travels with step 0's group; word step j + 1 with step
  // 4j + 2's, started at step 4j (after its barrier, when no thread reads
  // word step j - 1's slot any more) and waited for at step 4j + 4
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st == 0) copy_words<BM, BN>(words, wp2, 0, p0, M2, K4, NB);
    if (st < NB)
      copy_step<BM, BN>(scl + st * TL::kScales, xs + st * TL::kX, scales,
                         scale_kind, bf16_pairs, x, st, p0, t0, T, M2, K4,
                         NB);
    cp_async_commit();
  }

  for (int b = 0; b < NB; ++b) {
    cp_async_wait<kStages - 2>();                // step b's copies landed
    __syncthreads();                             // for every thread; and
                                                 // step b - 1's reads done
    {
      const int nb = b + kStages - 1;
      const int st = nb % kStages;
      const int j = b / kWordSteps + 1;
      if (b % kWordSteps == 0 && kWordSteps * j < NB)
        copy_words<BM, BN>(words + (j & 1) * TL::kWords, wp2, j, p0, M2,
                            K4, NB);
      if (nb < NB)
        copy_step<BM, BN>(scl + st * TL::kScales, xs + st * TL::kX, scales,
                           scale_kind, bf16_pairs, x, nb, p0, t0, T, M2, K4,
                           NB);
      cp_async_commit();
    }
    const int st = b % kStages;
    const uint32_t* ss = scl + st * TL::kScales;
    const __nv_bfloat16* xt = xs + st * TL::kX;

    // this lane's 8 words (r = 0..7 of its half) and scales
    __nv_bfloat162 se, so;
    const int pl = wm * 8 + g;                   // row pair in the tile
    const uint4* wv = reinterpret_cast<const uint4*>(
        words + ((b / kWordSteps) & 1) * TL::kWords + pl * kPairW +
        half * 40 + (b % kWordSteps) * 8);
    const uint4 wlo = wv[0], whi = wv[1];
    {
      __nv_bfloat16 s0, s1;
      if (scale_kind == 0) {
        s0 = __float2bfloat16_rn(__uint_as_float(ss[2 * pl]));
        s1 = __float2bfloat16_rn(__uint_as_float(ss[2 * pl + 1]));
      } else if (scale_kind == 1) {
        const int shs = bf16_pairs ? 16 * (b & 1) : 0;
        s0 = bf16_from_bits(ss[2 * pl] >> shs);
        s1 = bf16_from_bits(ss[2 * pl + 1] >> shs);
      } else {
        s0 = bf16_from_bits(ss[pl]);
        s1 = bf16_from_bits(ss[pl] >> 16);
      }
      if (has_factor) {
        s0 = __hmul(s0, fac);
        s1 = __hmul(s1, fac);
      }
      se = __halves2bfloat162(s0, s0);
      so = __halves2bfloat162(s1, s1);
    }

    float blk[4][2][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) blk[a][n][c] = 0.f;

#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // words r = 2s (columns 16s + 0..7) and r = 2s + 1 (16s + 8..15)
      const uint4 v = s < 2 ? wlo : whi;
      const uint32_t w1 = (s & 1) ? v.z : v.x;
      const uint32_t w2 = (s & 1) ? v.w : v.y;
      const uint32_t be[2] = {decode2(tbl, w1, sh, se),
                              decode2(tbl, w2, sh, se)};
      const uint32_t bo[2] = {decode2(tbl, w1, sh + 16, so),
                              decode2(tbl, w2, sh + 16, so)};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        uint32_t af[4];
        const int row =
            wt * kWarpT + a * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldmatrix_x4(af, xt + row * kLdx + 16 * s + 8 * (lane >> 4));
        mma_bf16(blk[a][0], af, be);
        mma_bf16(blk[a][1], af, bo);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][n][c] += blk[a][n][c];
  }
  cp_async_wait<0>();

  // epilogue: c[2hh + j] at token g + 8hh, pair 2tg + j of the n8 tile;
  // the even row's and the odd row's values side by side
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = t0 + wt * kWarpT + a * 16 + g + 8 * hh;
      if (t >= T) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = p0 + wm * 8 + 2 * tg + j;
        if (i < M2)
          *reinterpret_cast<float2*>(y + (size_t)t * M + 2 * i) =
              make_float2(acc[a][0][2 * hh + j], acc[a][1][2 * hh + j]);
      }
    }
}

template <int BM, int BN>
cudaError_t launch_tile(const int32_t* wp2, const void* scales, int kind,
                        const __nv_bfloat16* table, const __nv_bfloat16* x,
                        float* y, int T, int M2, int K4, int has_factor,
                        float factor, cudaStream_t stream) {
  using TL = Tile<BM, BN>;
  if (TL::kSmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pair_mma_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)TL::kSmem);
    if (e != cudaSuccess) return e;
  }
  // bf16 scales come as aligned 4-byte pairs when every (m, b & ~1)
  // element starts one: NB even and the base 4-byte aligned
  const int NB = K4 / 16;
  const int bf16_pairs =
      kind == 1 && NB % 2 == 0 && reinterpret_cast<uintptr_t>(scales) % 4 == 0;
  dim3 grid((T + BN - 1) / BN, (2 * M2 + BM - 1) / BM);
  pair_mma_kernel<BM, BN><<<grid, TL::kThreads, TL::kSmem, stream>>>(
      wp2, scales, kind, bf16_pairs, table, x, y, T, M2, K4, has_factor,
      factor);
  return cudaGetLastError();
}

}  // namespace

// y[T, 2*M2] fp32 = x[T, 4*K4] bf16 . dequant(wp2[M2, K4], scales)^T, the
// arguments of qt_pair_matmul, with the tile: bm in {32, 64, 128} weight
// rows, bn in {64, 128} tokens. K4 must be a multiple of 16 (K a multiple
// of 64); x is 16-byte aligned. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a tile it does not have).
extern "C" int qt_pair_mma(const void* wp2, const void* scales,
                           int scale_kind, const void* table, const void* x,
                           void* y, int T, int M2, int K4, int has_factor,
                           float factor, int bm, int bn, void* stream) {
  auto w = static_cast<const int32_t*>(wp2);
  auto tb = static_cast<const __nv_bfloat16*>(table);
  auto xx = static_cast<const __nv_bfloat16*>(x);
  auto yy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
#define QT_TILE(BM_, BN_)                                                    \
  if (bm == BM_ && bn == BN_)                                                \
    return static_cast<int>(launch_tile<BM_, BN_>(                          \
        w, scales, scale_kind, tb, xx, yy, T, M2, K4, has_factor, factor, st));
  QT_TILE(128, 128)
  QT_TILE(64, 128)
  QT_TILE(32, 128)
  QT_TILE(128, 64)
  QT_TILE(64, 64)
  QT_TILE(32, 64)
#undef QT_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
