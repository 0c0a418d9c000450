// K1's split-K tensor-core body for sm_90a: the pair-layout W4A16
// dequant + matmul from PAIR_SPLITK_MIN_TOKENS (3) up to 128 token rows
// (ops/qmatmul.py pair_body "splitk"), behind one entry point,
// qt_pair_splitk, with qt_pair_matmul's arguments. It computes the function of
// quantizations_tpu/ops/qmatmul.py:481 _pair_kernel, reached through
// matmul_4bit_pair_pallas (:588, the lm_head) and
// matmul_4bit_pair_pallas_stacked (:662, every projection; the stacked
// form passes a pointer to layer idx). K9 routes by the same pair_body,
// so at these rows it launches this body too, for the function of
// :1048 _manual_kernel_body (matmul_4bit_pair_manual :1103,
// matmul_4bit_pair_manual_stacked :1163), and stays K1's bits.
//
//   y[t, m] = sum_k bf16(x[t, k]) * W[m, k]          (fp32 accumulation)
//   W[m, k] = bf16(table[code(m, k)] * s_bf)          (__hmul2, RNE)
//   s_bf    = bf16(scale[m, k / 64]), then bf16(s_bf * bf16(out_factor))
//
// K1's rounding class (csrc/pair_matmul.cu): the same bf16 weights and
// activations, whose products are exact in fp32; only the order of the
// fp32 sums differs (the tensor cores', then the warps').
//
// Bound: the weight bytes. At T = 8 the 129 launches of a Llama3-8B
// forward read 4.2 GB of words and scales, 1.26 ms at 3.35 TB/s, against
// 0.15 ms of bf16 tensor-core work; at T = 128 the operations come to
// 1.96 TFLOP, 1.98 ms, against 1.38 ms of bytes with x and y. K1's
// CUDA-core body spends one fp32 FMA per weight and token and decodes
// every weight once per 16 tokens, so its pace is set by instructions
// per weight; this body decodes each weight once per 64 tokens and
// leaves the products to mma.sync.m16n8k16 (bf16 x bf16, fp32 sums). It
// is csrc/planar_matmul.cu's split-K body (K5's) on the pair layout:
//  - weights are the A operand, tokens the n8 tiles: all of T <= 64 is
//    one tile of NT <= 8 n8 tiles; from 65 to 128 rows a second 64-token
//    tile goes on the grid, in blockIdx.x (fastest), so the two tiles of
//    a row block run together and the second reads its words from L2;
//  - rows g and g + 8 of an m16 tile are the even and the odd row of row
//    pair g. Of the A fragment for a 16-column step s, lane (g, tg) holds
//    columns 16s + 2tg, +1 and 16s + 8 + 2tg, +9 of both rows: in the
//    pair layout the nibble pair 8(tg & 1) of the words (row pair g,
//    half tg / 2, r = 2s) and (.., r = 2s + 1), the low 16 bits the even
//    row, the high 16 the odd row (csrc/pair_prefill.cu's column
//    arithmetic). So all four A registers come from two words;
//  - the scales: one bf16x2 word holds a lane's two scales for a block
//    (fp32 and bf16 scales take two loads); decode is the 16-entry bf16
//    table in shared memory and __hmul2 by (s_bf, s_bf): K1's rounding
//    points;
//  - the B fragments come from the activation tile in its original
//    column order with ldmatrix.x4 (rows padded to 72 values: no bank
//    conflicts), no permuted copy of x;
//  - split K: a block owns 8 MT row pairs (MT m16 tiles); each of its KS
//    warps takes its own range of whole chunks of 8 consecutive 64-column
//    scale blocks, so each of a row pair's 16 word runs (2 halves x 8
//    r) is one 32-byte sector a chunk. A chunk's words come through two
//    word slots (chunk j + 1 copied while chunk j is computed, 8 lanes a
//    run, 4 bytes a lane, stored [pair][half][block][r] and padded so
//    that a lane reads its 8 words of a block as two conflict-free
//    16-byte loads); a block's scales and activation rows through a
//    cp.async ring of ST stages. Each warp's copies are its own, awaited
//    with wait_group + __syncwarp: no block barrier in the K loop;
//  - two-level fp32 sums, as in csrc/pair_prefill.cu: the mma
//    accumulators of one 64-column block start at zero and the block's
//    partial is added to the warp's running sum with an ordinary add;
//  - at the end each warp writes its partial into its own ring and,
//    after the block's only barrier, the warps' partials are added in
//    warp order: no atomics, reruns give the same bits. Accumulators c0 /
//    c2 and c1 / c3 are rows 2i and 2i + 1 of one token: the epilogue
//    writes each pair as one float2.
// Any even M, any T >= 1 and K a multiple of 64; token, row and block
// tails are zero-filled and masked. mma.sync only: no wgmma, TMA or
// clusters.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;      // scale blocks a word chunk
constexpr int kLdx = 64 + 8;   // activation stage row, in bf16
// A word slot, per row pair: half h at h * kHalfW, block bb of the chunk
// at bb * 8, word r at r (72 and 148 words: the four (pair, half) rows
// that a quarter-warp reads fall in four disjoint bank groups)
constexpr int kHalfW = 72;
constexpr int kPairW = 148;

template <int NT, int MT, int KS, int ST>
struct Shape {
  static constexpr int kPairs = 8 * MT;            // row pairs a block
  static constexpr int kThreads = 32 * KS;
  static constexpr int kSlotW = kPairs * kPairW;   // uint32 a word slot
  static constexpr int kX = 8 * NT * kLdx;         // bf16 a stage
  static constexpr int kSc = 2 * kPairs;           // uint32 a stage
  static constexpr int kStage = 2 * kX + 4 * kSc;  // bytes
  static constexpr int kRing = 2 * 4 * kSlotW + ST * kStage;   // a warp
  static constexpr int kPartLd = 2 * kPairs + 4;   // floats a partial row
  static constexpr size_t kSmem = (size_t)KS * kRing;
  static_assert(kRing % 16 == 0, "16-byte aligned rings");
  static_assert(8 * NT * kPartLd * 4 <= kRing, "a partial fits its ring");
  static_assert(ST >= 2 && ST <= kChunk + 1, "the word chunk lands in time");
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* smem) {
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

template <int NT, int MT, int KS, int ST>
__global__ void __launch_bounds__(32 * KS)
pair_splitk_kernel(const int32_t* __restrict__ wp2,
                   const void* __restrict__ scales, int scale_kind,
                   const __nv_bfloat16* __restrict__ table,
                   const __nv_bfloat16* __restrict__ x,
                   float* __restrict__ y, int T, int M2, int K4,
                   int has_factor, float factor) {
  using SH = Shape<NT, MT, KS, ST>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __nv_bfloat16 tbl[16];

  const int NB = K4 / 16;
  const int K8 = K4 / 2;
  const int K = 4 * K4;
  const int M = 2 * M2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;       // mma fragment coordinates
  const int sh = 8 * (tg & 1);                  // the lane's nibble pair
  const int half = tg >> 1;                     // and its half-word
  const int t0 = blockIdx.x * 8 * NT;
  const int p0 = blockIdx.y * SH::kPairs;       // first row pair
  const int tv = min(T - t0, 8 * NT);           // the tile's tokens
  // this warp's chunks [c0, c1) of the NC chunks of 8 blocks, and blocks
  const int NC = (NB + kChunk - 1) / kChunk;
  const int c0 = (int)((long long)warp * NC / KS);
  const int c1 = (int)((long long)(warp + 1) * NC / KS);
  const int bs = kChunk * c0;
  const int nblk = max(0, min(kChunk * c1, NB) - bs);
  const __nv_bfloat16 fac = __float2bfloat16_rn(factor);
  // bf16 scales come as the aligned 4-byte word holding them: which half
  const unsigned s_half0 =
      static_cast<unsigned>(reinterpret_cast<uintptr_t>(scales) >> 1);
  unsigned char* ring = smem + (size_t)warp * SH::kRing;
  uint32_t* slots = reinterpret_cast<uint32_t*>(ring);
  unsigned char* stages = ring + 2 * 4 * SH::kSlotW;

  if (threadIdx.x < 16) tbl[threadIdx.x] = table[threadIdx.x];
  // activation rows past the tile's tokens are never copied: zero them
  // once in every stage
  for (int q = lane; q < ST * (8 * NT - tv) * 9; q += 32) {
    const int st = q / ((8 * NT - tv) * 9), r = q % ((8 * NT - tv) * 9);
    *reinterpret_cast<uint4*>(stages + st * SH::kStage +
                              2 * (tv + r / 9) * kLdx + 16 * (r % 9)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // chunk c's words into slot `slot`: 16 MT runs a pass, 8 lanes a run
  // (block bb = lane & 7 of the chunk, r = 4 (it & 1) + (lane >> 3)), zero
  // past M2 or NB
  auto copy_words = [&](int c, int slot) {
    uint32_t* dst = slots + slot * SH::kSlotW;
    const int bb = lane & 7, b = kChunk * c + bb;
#pragma unroll
    for (int it = 0; it < 4 * SH::kPairs; ++it) {
      const int p = it >> 2, h = (it >> 1) & 1;
      const int r = 4 * (it & 1) + (lane >> 3);
      const bool ok = p0 + p < M2 && b < NB;
      cp_async4(dst + p * kPairW + h * kHalfW + bb * 8 + r,
                wp2 + (ok ? (size_t)(p0 + p) * K4 + h * K8 + r * NB + b : 0),
                ok);
    }
  };
  // block b's scales and activation rows into stage st: the scales of the
  // block's rows (fp32: one a row; bf16: the aligned word holding it;
  // bf16x2: one a row pair), x's 64 columns of block b for the tile's
  // tokens (8 lanes a token, 4 tokens a pass)
  auto copy_step = [&](int b, int st) {
    unsigned char* base = stages + st * SH::kStage;
    uint32_t* sc = reinterpret_cast<uint32_t*>(base + 2 * SH::kX);
    if (scale_kind == 2) {
      const int32_t* s = static_cast<const int32_t*>(scales);
      for (int q = lane; q < SH::kPairs; q += 32) {
        const bool ok = p0 + q < M2;
        cp_async4(sc + q, s + (ok ? (size_t)(p0 + q) * NB + b : 0), ok);
      }
    } else {
      const int s_size = scale_kind == 0 ? 4 : 2;
      for (int q = lane; q < 2 * SH::kPairs; q += 32) {
        const int m = 2 * p0 + q;
        const bool ok = m < M;
        const char* src = static_cast<const char*>(scales) +
                          (ok ? ((size_t)m * NB + b) * s_size : 0);
        cp_async4(sc + q,
                  reinterpret_cast<const void*>(
                      reinterpret_cast<uintptr_t>(src) &
                      ~static_cast<uintptr_t>(3)),
                  ok);
      }
    }
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base);
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      const int t = 4 * j + (lane >> 3);
      if (t < tv)
        cp_async16(xs + t * kLdx + 8 * (lane & 7),
                   x + (size_t)(t0 + t) * K + 64 * b + 8 * (lane & 7));
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;

  // the first chunk's words travel with block 0's group; chunk j + 1's
  // with block 8j + ST - 1's, started at block 8j (after its __syncwarp,
  // when no lane reads chunk j - 1's slot any more) and landed by block
  // 8j + 8 since ST <= 9
  if (nblk > 0) copy_words(c0, 0);
#pragma unroll
  for (int st = 0; st < ST - 1; ++st) {
    if (st < nblk) copy_step(bs + st, st);
    cp_async_commit();
  }

  for (int i = 0; i < nblk; ++i) {
    cp_async_wait<ST - 2>();  // this lane's copies of block i landed
    __syncwarp();             // every lane's; and block i - 1's reads done
    if (i + ST - 1 < nblk) copy_step(bs + i + ST - 1, (i + ST - 1) % ST);
    if (i % kChunk == 0 && i + kChunk < nblk)
      copy_words(c0 + i / kChunk + 1, (i / kChunk + 1) & 1);
    cp_async_commit();

    const int b = bs + i;
    const unsigned char* base = stages + (i % ST) * SH::kStage;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(base);
    const uint32_t* sc = reinterpret_cast<const uint32_t*>(base + 2 * SH::kX);
    const uint32_t* wslot =
        slots + ((i / kChunk) & 1) * SH::kSlotW + (i % kChunk) * 8;

    // this lane's 8 words (r = 0..7 of its half) and bf16 scale pair of
    // row pair 8 mt + g
    uint4 wv[MT][2];
    __nv_bfloat162 se[MT], so[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int pl = 8 * mt + g;
      const uint4* v = reinterpret_cast<const uint4*>(wslot + pl * kPairW +
                                                      half * kHalfW);
      wv[mt][0] = v[0];
      wv[mt][1] = v[1];
      __nv_bfloat16 s0, s1;
      if (scale_kind == 2) {
        const uint32_t u = sc[pl];
        s0 = bf16_from_bits(u);
        s1 = bf16_from_bits(u >> 16);
      } else if (scale_kind == 0) {
        s0 = __float2bfloat16_rn(__uint_as_float(sc[2 * pl]));
        s1 = __float2bfloat16_rn(__uint_as_float(sc[2 * pl + 1]));
      } else {
        const unsigned m = 2u * (unsigned)(p0 + pl);
        const unsigned e = s_half0 + m * (unsigned)NB + (unsigned)b;
        s0 = bf16_from_bits(sc[2 * pl] >> (16 * (e & 1u)));
        s1 = bf16_from_bits(sc[2 * pl + 1] >> (16 * ((e + NB) & 1u)));
      }
      if (has_factor) {
        s0 = __hmul(s0, fac);
        s1 = __hmul(s1, fac);
      }
      se[mt] = __halves2bfloat162(s0, s0);
      so[mt] = __halves2bfloat162(s1, s1);
    }

    float blk[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) blk[mt][n][c] = 0.f;

#pragma unroll
    for (int s = 0; s < 4; s += 2) {
      // B fragments of steps s and s + 1: tokens 8n + (lane & 7), columns
      // 16s + 8 (lane >> 3)
      uint32_t bf[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        ldsm_x4(bf[n], xs + (8 * n + (lane & 7)) * kLdx + 16 * s +
                           8 * (lane >> 3));
#pragma unroll
      for (int ss = 0; ss < 2; ++ss) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // words r = 2(s + ss) (columns 16(s + ss) + 0..7) and r + 1
          const uint4 v = wv[mt][s >> 1];
          const uint32_t w1 = ss ? v.z : v.x;
          const uint32_t w2 = ss ? v.w : v.y;
          const uint32_t a[4] = {decode2(tbl, w1, sh, se[mt]),
                                 decode2(tbl, w1, sh + 16, so[mt]),
                                 decode2(tbl, w2, sh, se[mt]),
                                 decode2(tbl, w2, sh + 16, so[mt])};
#pragma unroll
          for (int n = 0; n < NT; ++n)
            mma_bf16(blk[mt][n], a, &bf[n][2 * ss]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][n][c] += blk[mt][n][c];
  }
  cp_async_wait<0>();
  __syncwarp();

  // this warp's partial [8 NT tokens][kPartLd] into its own ring: c[2hh +
  // e] at row 2 pl + hh (pl = 8 mt + g), token 8n + 2tg + e; the even and
  // the odd row of a pair side by side
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(
            part + (8 * n + 2 * tg + e) * SH::kPartLd + 2 * (8 * mt + g)) =
            make_float2(acc[mt][n][e], acc[mt][n][2 + e]);
  __syncthreads();

  for (int q = threadIdx.x; q < tv * SH::kPairs; q += SH::kThreads) {
    const int t = q / SH::kPairs, p = q % SH::kPairs;
    if (p0 + p >= M2) continue;
    const float* src =
        reinterpret_cast<const float*>(smem) + t * SH::kPartLd + 2 * p;
    float2 v = *reinterpret_cast<const float2*>(src);
#pragma unroll
    for (int k = 1; k < KS; ++k) {
      const float2 u = *reinterpret_cast<const float2*>(
          src + (size_t)k * SH::kRing / 4);
      v.x += u.x;
      v.y += u.y;
    }
    *reinterpret_cast<float2*>(y + (size_t)(t0 + t) * M + 2 * (p0 + p)) = v;
  }
}

template <int NT, int MT, int KS, int ST>
cudaError_t launch_shape(const int32_t* wp2, const void* scales,
                         int scale_kind, const __nv_bfloat16* table,
                         const __nv_bfloat16* x, float* y, int T, int M2,
                         int K4, int has_factor, float factor,
                         cudaStream_t stream) {
  using SH = Shape<NT, MT, KS, ST>;
  if (SH::kSmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pair_splitk_kernel<NT, MT, KS, ST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SH::kSmem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((T + 8 * NT - 1) / (8 * NT),
            (M2 + SH::kPairs - 1) / SH::kPairs);
  pair_splitk_kernel<NT, MT, KS, ST><<<grid, SH::kThreads, SH::kSmem,
                                       stream>>>(
      wp2, scales, scale_kind, table, x, y, T, M2, K4, has_factor, factor);
  return cudaGetLastError();
}

}  // namespace

// K1 through its split-K tensor-core body: y[T, 2*M2] fp32 = x[T, 4*K4]
// bf16 . dequant(wp2[M2, K4], scales)^T, the arguments and layouts of
// qt_pair_matmul (scale_kind 0 = fp32 [M, NB], 1 = bf16 [M, NB], 2 =
// bf16x2 int32 [M/2, NB]). The block's shape (n8 tiles NT, m16 tiles MT,
// K slices KS, ring stages ST) from T, the fastest per Llama3-8B forward
// of the nine (MT, KS, ST) timed on an H100 at each token tile: up to 8
// tokens one n8 tile, 8 row pairs a block, 8 warps; 16 and 32 tokens 2
// and 4 n8 tiles, 16 row pairs, 8 warps; above, 8 n8 tiles, 16 row
// pairs, 4 warps (a second 64-token tile on the grid from 65 rows on);
// two stages throughout. K4 a multiple of 16 (K a multiple of 64); x
// 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int qt_pair_splitk(const void* wp2, const void* scales,
                              int scale_kind, const void* table,
                              const void* x, void* y, int T, int M2, int K4,
                              int has_factor, float factor, void* stream) {
  auto w = static_cast<const int32_t*>(wp2);
  auto tb = static_cast<const __nv_bfloat16*>(table);
  auto xx = static_cast<const __nv_bfloat16*>(x);
  auto yy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
#define QT_SPLITK(NT_, MT_, KS_, ST_)                                       \
  launch_shape<NT_, MT_, KS_, ST_>(w, scales, scale_kind, tb, xx, yy, T,   \
                                   M2, K4, has_factor, factor, st)
  cudaError_t e;
  if (T <= 8)
    e = QT_SPLITK(1, 1, 8, 2);
  else if (T <= 16)
    e = QT_SPLITK(2, 2, 8, 2);
  else if (T <= 32)
    e = QT_SPLITK(4, 2, 8, 2);
  else
    e = QT_SPLITK(8, 2, 4, 2);
#undef QT_SPLITK
  return static_cast<int>(e);
}
