// Planar-layout 4-bit dequant + matmul (kernel K5) and dequant + GEMV
// (kernel K6) for sm_90a: one kernel body, two rounding classes.
//
// K5 replaces quantizations_tpu/ops/qmatmul.py:43 _kernel, reached through
// matmul_4bit_pallas (:93, the planar lm_head and Linear4bit) and
// matmul_4bit_pallas_stacked (:154, every planar projection). bf16 class:
//
//   y[t, m] = sum_k bf16(x[t, k]) * W[m, k]               (fp32 sums)
//   W[m, k] = bf16_rn(fp32(table[code(m, k)] * s_bf))
//   s_bf    = bf16(scale[m, k / 64]), then bf16(s_bf * bf16(factor))
//             when factor != 1
//
// K6 replaces quantizations_tpu/ops/gemv.py:150 _gemv_kernel, reached
// through gemv_4bit_pallas (:296) and gemv_4bit_pallas_stacked (:353).
// fp32 class:
//
//   y[t, m] = factor * sum_b scale[m, b] * sum_{k in block b}
//                                            table[code(m, k)] * x[t, k]
//
// with x, the table (FP4: raw codebook x 12, factor 1/12; NF4: fp32
// codebook, factor 1) and every sum in fp32; bf16 scales are widened.
//
// Planar words wp [M, K/8]: word c of row m holds elements 8c..8c+7, the
// code of element j at bit 8*(j/2) + 4 - 4*(j%2) (bnb byte order).
// The stacked forms pass a pointer to layer idx.
//
// Bound: at decode (T <= 8) the weight bytes: the fused gate_up
// [28672, 4096] moves 58.7 MB of words and 7.3 MB of fp32 scales, 19.7 us
// at 3.35 TB/s; K6's fp32 products are 2*T*M*K flops over 67 TFLOP/s
// (at T = 8 about 14 us there). The design reads every weight byte once
// per token tile with 16-byte loads:
//  - a block of 8 warps owns 16 rows, two per warp; lane l of a warp
//    reads words 4l..4l+3 of each of its rows in a 128-word K step (one
//    int4 load a row), so the 4 words lie in one quant block, and a warp
//    reads 512 contiguous bytes a row per step;
//  - each K step stages the token tile's activations in shared memory as
//    fp32 planes xs[t][j][c] = x[t, 8c + j]: a lane reads one float4 per
//    (t, j) for its 4 words, conflict-free, and the two rows of a warp
//    share it;
//  - the 16-entry decode table sits in shared memory;
//  - K6 sums a quant block's 64 products over the lane pair that holds it
//    (one shuffle), then scales; K5 scales every weight before its
//    product, as the TPU kernel does.
// A tile of TT <= 16 tokens (K5) or 8 (K6) lives in registers; larger T
// loops over token tiles in blockIdx.x (fastest), so the tiles of one row
// block run together and re-read its words from L2. Tensor cores (wgmma),
// TMA and pipelining are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;   // rows per block
constexpr int kStep = 128;                     // words per K step

__device__ __forceinline__ float load_scale(const void* scales, int kind,
                                            size_t idx) {
  if (kind == 0) return __ldg(static_cast<const float*>(scales) + idx);
  return __bfloat162float(static_cast<const __nv_bfloat16*>(scales)[idx]);
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xFFFF0000u);
}

// x_kind: 0 = fp32, 1 = bf16. kBf16 selects K5's class, else K6's.
template <int TT, bool kBf16>
__global__ void __launch_bounds__(kThreads)
planar_kernel(const int32_t* __restrict__ wp, const void* __restrict__ scales,
              int scale_kind, const float* __restrict__ table,
              const void* __restrict__ x, int x_kind, float* __restrict__ y,
              int T, int M, int K8, int has_factor, float factor) {
  extern __shared__ float xs[];                  // [TT][8][kStep]
  __shared__ float tbl[16];

  const int NB = K8 / 8;
  const int K = 8 * K8;
  const int t0 = blockIdx.x * TT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * kRows + warp * kRowsPerWarp;
  const __nv_bfloat16 fac = __float2bfloat16_rn(factor);

  if (threadIdx.x < 16) tbl[threadIdx.x] = table[threadIdx.x];

  float acc[kRowsPerWarp][TT];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[r][t] = 0.f;

  for (int c0 = 0; c0 < K8; c0 += kStep) {
    __syncthreads();   // the previous step's reads of xs are done
    for (int q = threadIdx.x; q < TT * kStep; q += kThreads) {
      const int t = q / kStep, cl = q - t * kStep, c = c0 + cl;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
      if (t0 + t < T && c < K8) {
        const size_t at = (size_t)(t0 + t) * K + 8 * (size_t)c;
        if (x_kind == 1) {
          const uint4 u = __ldg(reinterpret_cast<const uint4*>(
              static_cast<const __nv_bfloat16*>(x) + at));
          const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            v[2 * h] = bf16_lo(w4[h]);
            v[2 * h + 1] = bf16_hi(w4[h]);
          }
        } else {
          const float4* p =
              reinterpret_cast<const float4*>(static_cast<const float*>(x) + at);
          const float4 a = __ldg(p), b = __ldg(p + 1);
          v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
          v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) xs[(t * 8 + j) * kStep + cl] = v[j];
    }
    __syncthreads();

    const int cw = c0 + 4 * lane;                 // this lane's first word
    uint32_t w[kRowsPerWarp][4];
    float s[kRowsPerWarp];
    bool ok[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int m = row0 + r;
      ok[r] = cw < K8 && m < M;
      int4 v = make_int4(0, 0, 0, 0);
      s[r] = 0.f;
      if (ok[r]) {
        v = __ldg(reinterpret_cast<const int4*>(wp + (size_t)m * K8 + cw));
        s[r] = load_scale(scales, scale_kind, (size_t)m * NB + (cw >> 3));
        if (kBf16) {
          __nv_bfloat16 sb = __float2bfloat16_rn(s[r]);
          if (has_factor) sb = __hmul(sb, fac);
          s[r] = __bfloat162float(sb);
        }
      }
      w[r][0] = static_cast<uint32_t>(v.x);
      w[r][1] = static_cast<uint32_t>(v.y);
      w[r][2] = static_cast<uint32_t>(v.z);
      w[r][3] = static_cast<uint32_t>(v.w);
    }

    float part[kRowsPerWarp][TT];    // K6: this lane's half-block sums
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int t = 0; t < TT; ++t) part[r][t] = 0.f;

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int sh = 8 * (j >> 1) + 4 - 4 * (j & 1);
      float wv[kRowsPerWarp][4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float d = tbl[(w[r][q] >> sh) & 15u];
          wv[r][q] = kBf16 ? __bfloat162float(
                                 __float2bfloat16_rn(__fmul_rn(d, s[r])))
                           : d;
        }
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        const float4 xv = *reinterpret_cast<const float4*>(
            &xs[(t * 8 + j) * kStep + 4 * lane]);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          if (!ok[r]) continue;
          float& a = kBf16 ? acc[r][t] : part[r][t];
          a = fmaf(xv.x, wv[r][0], a);
          a = fmaf(xv.y, wv[r][1], a);
          a = fmaf(xv.z, wv[r][2], a);
          a = fmaf(xv.w, wv[r][3], a);
        }
      }
    }
    if (!kBf16) {
      // lanes 2p and 2p+1 hold quant block p of the step: both get its
      // 64-product sum, times the fp32 scale
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          const float b =
              part[r][t] + __shfl_xor_sync(0xffffffffu, part[r][t], 1);
          acc[r][t] += __fmul_rn(b, s[r]);
        }
    }
  }

  // K5 sums over all 32 lanes; K6 over one lane of each pair (the pair's
  // two lanes hold the same block sums)
  constexpr int kLast = kBf16 ? 1 : 2;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      float v = acc[r][t];
#pragma unroll
      for (int off = 16; off >= kLast; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      const int m = row0 + r;
      if (lane == 0 && m < M && t0 + t < T) {
        if (!kBf16 && has_factor) v *= factor;
        y[(size_t)(t0 + t) * M + m] = v;
      }
    }
}

template <int TT, bool kBf16>
cudaError_t launch_tt(const int32_t* wp, const void* scales, int scale_kind,
                      const float* table, const void* x, int x_kind, float* y,
                      int T, int M, int K8, int has_factor, float factor,
                      cudaStream_t stream) {
  const size_t smem = (size_t)TT * 8 * kStep * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        planar_kernel<TT, kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((T + TT - 1) / TT, (M + kRows - 1) / kRows);
  planar_kernel<TT, kBf16><<<grid, kThreads, smem, stream>>>(
      wp, scales, scale_kind, table, x, x_kind, y, T, M, K8, has_factor,
      factor);
  return cudaGetLastError();
}

}  // namespace

// K5: y[T, M] fp32 = x[T, 8*K8] bf16 . dequant(wp[M, K8], scales)^T in the
// bf16 class. scale_kind: 0 = fp32, 1 = bf16 scales [M, K8/8]; table: 16
// fp32 decode values; K8 a multiple of 8; wp and x 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int qt_planar_matmul(const void* wp, const void* scales,
                                int scale_kind, const void* table,
                                const void* x, void* y, int T, int M, int K8,
                                int has_factor, float factor, void* stream) {
  auto w = static_cast<const int32_t*>(wp);
  auto tb = static_cast<const float*>(table);
  auto yy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (T <= 1)
    e = launch_tt<1, true>(w, scales, scale_kind, tb, x, 1, yy, T, M, K8,
                           has_factor, factor, st);
  else if (T <= 2)
    e = launch_tt<2, true>(w, scales, scale_kind, tb, x, 1, yy, T, M, K8,
                           has_factor, factor, st);
  else if (T <= 4)
    e = launch_tt<4, true>(w, scales, scale_kind, tb, x, 1, yy, T, M, K8,
                           has_factor, factor, st);
  else if (T <= 8)
    e = launch_tt<8, true>(w, scales, scale_kind, tb, x, 1, yy, T, M, K8,
                           has_factor, factor, st);
  else
    e = launch_tt<16, true>(w, scales, scale_kind, tb, x, 1, yy, T, M, K8,
                            has_factor, factor, st);
  return static_cast<int>(e);
}

// K6: y[T, M] fp32 = x[T, 8*K8] . dequant(wp[M, K8], scales)^T in the fp32
// class, x fp32 (x_kind 0) or bf16 (1); same layouts as qt_planar_matmul.
extern "C" int qt_gemv_4bit(const void* wp, const void* scales,
                            int scale_kind, const void* table, const void* x,
                            int x_kind, void* y, int T, int M, int K8,
                            int has_factor, float factor, void* stream) {
  auto w = static_cast<const int32_t*>(wp);
  auto tb = static_cast<const float*>(table);
  auto yy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (T <= 1)
    e = launch_tt<1, false>(w, scales, scale_kind, tb, x, x_kind, yy, T, M,
                            K8, has_factor, factor, st);
  else if (T <= 2)
    e = launch_tt<2, false>(w, scales, scale_kind, tb, x, x_kind, yy, T, M,
                            K8, has_factor, factor, st);
  else if (T <= 4)
    e = launch_tt<4, false>(w, scales, scale_kind, tb, x, x_kind, yy, T, M,
                            K8, has_factor, factor, st);
  else
    e = launch_tt<8, false>(w, scales, scale_kind, tb, x, x_kind, yy, T, M,
                            K8, has_factor, factor, st);
  return static_cast<int>(e);
}
