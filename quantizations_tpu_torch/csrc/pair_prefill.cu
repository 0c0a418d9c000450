// Decode-once prefill pair kernel (kernel K8) for sm_90a: a W4A16
// tensor-core GEMM over pair-layout 4-bit weights.
//
// Replaces quantizations_tpu/ops/qmatmul.py:755 _pair_prefill_kernel,
// reached through matmul_4bit_pair_prefill_pallas (:837) and
// matmul_4bit_pair_prefill_pallas_stacked (:891; the stacked form passes
// this kernel a pointer to layer idx).
//
//   y[t, m] = sum_k bf16(x[t, k]) * W[m, k]          (fp32 accumulation)
//   W[m, k] = bf16(table[code(m, k)] * s_bf)          (__hmul, RNE)
//   s_bf    = bf16(scale[m, k / 64]), then bf16(s_bf * bf16(out_factor))
//
// K1's rounding class (csrc/pair_matmul.cu): the same weights and
// activations, fp32 sums in another order (the tensor cores').
//
// Bound: at prefill (T = 512) the operations, not the bytes: the 128
// projections of a Llama3-8B forward are 7.15 TFLOP, 7.2 ms at the
// 989 TFLOP/s of the bf16 tensor cores, against 2.3 ms for their bytes.
// The TPU kernel decodes each weight tile once and keeps the whole
// activation resident while it loops over T; this first GPU kernel is
// simpler:
//  - a block of 8 warps owns a tile of BM = 128 output rows (64 row
//    pairs) and BN = 64 tokens, and walks K one 64-column scale block at
//    a time;
//  - each step decodes the tile's 64 x 16 pair words into a bf16
//    shared-memory tile in ORIGINAL column order (so x is read
//    unpermuted), with K1's table and __hmul rounding points, and stages
//    the bf16 activation tile beside it;
//  - the warps multiply with mma.sync m16n8k16 (bf16 in, fp32
//    accumulators in registers): warp (wt, wm) owns 32 tokens x 32 rows;
//  - two-level sums: the tensor cores chain their (truncating) fp32
//    additions over one 64-column block only, and each block's partial
//    sum is added to the running total with an ordinary round-to-nearest
//    fp32 add, so the error does not grow with K's 224 blocks as one
//    chained accumulator's would;
//  - a weight tile is decoded once per (row tile, token tile), i.e.
//    T / 64 times, not once; decoding once per weight tile (persistent
//    blocks, wgmma with TMA multicast) and overlapping the loads with the
//    math are for a later redesign.
// Any T >= 1 and any even M: the token and row tails are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                  // 8 warps: 2 (T) x 4 (M)
constexpr int BM = 128;                        // output rows per block
constexpr int BN = 64;                         // tokens per block
constexpr int BK = 64;                         // one scale block
constexpr int LDS = BK + 8;                    // padded row, in bf16:
                                               // conflict-free fragments

__device__ __forceinline__ __nv_bfloat16 bf16_from_bits(uint32_t bits) {
  __nv_bfloat16_raw r;
  r.x = static_cast<unsigned short>(bits & 0xFFFFu);
  return __nv_bfloat16(r);
}

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v));
}

// scale_kind: 0 = fp32 [M, NB], 1 = bf16 [M, NB], 2 = bf16x2 int32 [M/2, NB]
// (row 2i in the low half), as in csrc/pair_matmul.cu.
__device__ __forceinline__ void load_scales(const void* scales, int kind,
                                            int i, int b, int NB,
                                            __nv_bfloat16& s0,
                                            __nv_bfloat16& s1) {
  if (kind == 0) {
    const float* s = static_cast<const float*>(scales);
    s0 = __float2bfloat16_rn(__ldg(s + (size_t)(2 * i) * NB + b));
    s1 = __float2bfloat16_rn(__ldg(s + (size_t)(2 * i + 1) * NB + b));
  } else if (kind == 1) {
    const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(scales);
    s0 = s[(size_t)(2 * i) * NB + b];
    s1 = s[(size_t)(2 * i + 1) * NB + b];
  } else {
    const uint32_t u = static_cast<uint32_t>(
        __ldg(static_cast<const int32_t*>(scales) + (size_t)i * NB + b));
    s0 = bf16_from_bits(u);
    s1 = bf16_from_bits(u >> 16);
  }
}

// Two bf16 weights decoded from nibbles at shift sh and sh + 4.
__device__ __forceinline__ uint32_t decode2(const __nv_bfloat16* tbl,
                                            uint32_t w, int sh,
                                            __nv_bfloat16 s) {
  return bits_of(__hmul(tbl[(w >> sh) & 15u], s)) |
         (bits_of(__hmul(tbl[(w >> (sh + 4)) & 15u], s)) << 16);
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

__global__ void __launch_bounds__(kThreads)
pair_prefill_kernel(const int32_t* __restrict__ wp2,
                    const void* __restrict__ scales, int scale_kind,
                    const __nv_bfloat16* __restrict__ table,
                    const __nv_bfloat16* __restrict__ x,
                    float* __restrict__ y, int T, int M2, int K4,
                    int has_factor, float factor) {
  __shared__ __align__(16) __nv_bfloat16 ws[BM][LDS];   // decoded weights
  __shared__ __align__(16) __nv_bfloat16 xs[BN][LDS];   // activations
  __shared__ __nv_bfloat16 tbl[16];

  const int NB = K4 / 16;
  const int K8 = K4 / 2;
  const int K = 4 * K4;
  const int M = 2 * M2;
  const int t0 = blockIdx.x * BN;
  const int p0 = blockIdx.y * (BM / 2);          // first row pair
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;        // mma fragment coordinates
  const int wt = warp & 1, wm = warp >> 1;       // 32 tokens x 32 rows
  const __nv_bfloat16 fac = __float2bfloat16_rn(factor);

  if (threadIdx.x < 16) tbl[threadIdx.x] = table[threadIdx.x];

  // decode role: row pair dp of the tile, word steps r = 2 dq, 2 dq + 1
  const int dp = threadIdx.x >> 2, dq = threadIdx.x & 3;
  const int di = p0 + dp;
  const bool drow_ok = di < M2;
  const int32_t* wrow = wp2 + (size_t)(drow_ok ? di : 0) * K4;

  float acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][n][c] = 0.f;

  for (int b = 0; b < NB; ++b) {
    __syncthreads();   // the previous step's fragment reads are done
    // -- decode: columns 8r..8r+7 of rows 2 dp, 2 dp + 1 per word pair --
    {
      uint4 ve[2], vo[2];
      if (drow_ok) {
        __nv_bfloat16 s0, s1;
        load_scales(scales, scale_kind, di, b, NB, s0, s1);
        if (has_factor) {
          s0 = __hmul(s0, fac);
          s1 = __hmul(s1, fac);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = 2 * dq + j;
          const uint32_t lo = static_cast<uint32_t>(__ldg(wrow + r * NB + b));
          const uint32_t hi =
              static_cast<uint32_t>(__ldg(wrow + K8 + r * NB + b));
          // row 2i: nibbles 0..3 of each half-word; row 2i+1: 4..7
          ve[j] = make_uint4(decode2(tbl, lo, 0, s0), decode2(tbl, lo, 8, s0),
                             decode2(tbl, hi, 0, s0), decode2(tbl, hi, 8, s0));
          vo[j] = make_uint4(decode2(tbl, lo, 16, s1),
                             decode2(tbl, lo, 24, s1),
                             decode2(tbl, hi, 16, s1),
                             decode2(tbl, hi, 24, s1));
        }
      } else {
        ve[0] = ve[1] = vo[0] = vo[1] = make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = 2 * dq + j;
        *reinterpret_cast<uint4*>(&ws[2 * dp][8 * r]) = ve[j];
        *reinterpret_cast<uint4*>(&ws[2 * dp + 1][8 * r]) = vo[j];
      }
    }
    // -- stage x[t0 .. t0 + 63, 64b .. 64b + 63] --
    for (int q = threadIdx.x; q < BN * 8; q += kThreads) {
      const int t = q >> 3, c = q & 7;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t0 + t < T)
        v = __ldg(reinterpret_cast<const uint4*>(
            x + (size_t)(t0 + t) * K + 64 * b + 8 * c));
      *reinterpret_cast<uint4*>(&xs[t][8 * c]) = v;
    }
    __syncthreads();
    // -- 4 k16 steps of 2 x 4 mma tiles per warp, into the block sum --
    float blk[2][4][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) blk[a][n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int tr = wt * 32 + a * 16 + g;
        af[a][0] = *reinterpret_cast<const uint32_t*>(&xs[tr][kk + 2 * tg]);
        af[a][1] =
            *reinterpret_cast<const uint32_t*>(&xs[tr + 8][kk + 2 * tg]);
        af[a][2] =
            *reinterpret_cast<const uint32_t*>(&xs[tr][kk + 8 + 2 * tg]);
        af[a][3] =
            *reinterpret_cast<const uint32_t*>(&xs[tr + 8][kk + 8 + 2 * tg]);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int mr = wm * 32 + n * 8 + g;
        bfr[n][0] = *reinterpret_cast<const uint32_t*>(&ws[mr][kk + 2 * tg]);
        bfr[n][1] =
            *reinterpret_cast<const uint32_t*>(&ws[mr][kk + 8 + 2 * tg]);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_bf16(blk[a][n], af[a], bfr[n]);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][n][c] += blk[a][n][c];
  }

  // -- epilogue: c0, c1 at (token g, rows 2tg, 2tg+1); c2, c3 at g + 8 --
  const int m0 = 2 * p0;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int m = m0 + wm * 32 + n * 8 + 2 * tg;
      if (m >= M) continue;                      // M even: m + 1 < M too
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + wt * 32 + a * 16 + g + 8 * hh;
        if (t < T)
          *reinterpret_cast<float2*>(y + (size_t)t * M + m) =
              make_float2(acc[a][n][2 * hh], acc[a][n][2 * hh + 1]);
      }
    }
}

}  // namespace

// y[T, 2*M2] fp32 = x[T, 4*K4] bf16 . dequant(wp2[M2, K4], scales)^T, the
// arguments of qt_pair_matmul. K4 must be a multiple of 16 (K a multiple
// of 64); x is 16-byte aligned. Returns cudaGetLastError() after the
// launch.
extern "C" int qt_pair_prefill(const void* wp2, const void* scales,
                               int scale_kind, const void* table,
                               const void* x, void* y, int T, int M2, int K4,
                               int has_factor, float factor, void* stream) {
  dim3 grid((T + BN - 1) / BN, (2 * M2 + BM - 1) / BM);
  auto st = static_cast<cudaStream_t>(stream);
  pair_prefill_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const int32_t*>(wp2), scales, scale_kind,
      static_cast<const __nv_bfloat16*>(table),
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(y), T, M2, K4,
      has_factor, factor);
  return static_cast<int>(cudaGetLastError());
}
