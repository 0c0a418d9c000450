// Blockwise 4-bit quantize (kernel K2) for sm_90a.
//
// Replaces quantizations_tpu/ops/quantize.py:93 _quantize_kernel
// (quantize_4bit_pallas :142). For each block of `blocksize` consecutive
// elements of a row-major W [M, K] (K a multiple of blocksize):
//   absmax = max |w|;  inv = absmax > 0 ? 1.0f / absmax : 0
//   code   = FP4 ladder (bnb dQuantizeFP4, fp32 literal thresholds) or
//            the NF4 count of fp32 midpoints strictly below w * inv
// and 8 codes per int32 word in bnb byte order (element j at bit
// 8*(j/2) + 4 - 4*(j%2): high nibble = even element).
// Outputs wp int32 [M, K/8] and absmax fp32 [M, K/blocksize], bit-exact
// with quantizations_tpu.quant.quantize_4bit. Built without fast math:
// 1.0f / absmax must be the IEEE quotient.
//
// Bound: bytes. It reads W once (4 or 2 bytes per element) and writes
// 1/8 of an fp32 W back. One thread owns one quant block: a max pass and
// an encode pass over the same 16-byte vectors (the second pass hits
// L1/L2), so no cross-thread reduction is needed. The TPU kernel's
// plane-major permutation and one-hot matmuls worked around Mosaic's
// missing strided lane access and are not needed here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t fp4_code(float x) {
  const float a = fabsf(x);
  uint32_t c;
  if (a > 0.29166667f) {
    if (a > 0.583333f)
      c = a > 0.8333333f ? 3u : 2u;
    else
      c = a > 0.4166667f ? 5u : 4u;
  } else {
    if (a > 0.0859375f)
      c = a > 0.20833333f ? 7u : 6u;
    else
      c = a > 0.00260417f ? 1u : 0u;
  }
  return c + (x < 0.f ? 8u : 0u);
}

__device__ __forceinline__ uint32_t nf4_code(float x, const float* mids) {
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < 15; ++i) c += x > mids[i] ? 1u : 0u;
  return c;
}

// Eight consecutive elements as fp32 (exact widening for bf16 input).
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v[2 * c] = __uint_as_float(u[c] << 16);
    v[2 * c + 1] = __uint_as_float(u[c] & 0xFFFF0000u);
  }
}

template <typename TIn>
__global__ void __launch_bounds__(kThreads)
quantize_4bit_kernel(const TIn* __restrict__ W,
                     const float* __restrict__ mids_in,
                     int32_t* __restrict__ wp, float* __restrict__ absmax,
                     long long nblocks, int blocksize, int nf4) {
  float mids[15];
#pragma unroll
  for (int i = 0; i < 15; ++i) mids[i] = nf4 ? __ldg(mids_in + i) : 0.f;

  const long long blk = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (blk >= nblocks) return;
  const TIn* src = W + blk * blocksize;
  const int words = blocksize / 8;

  float m = 0.f;
  for (int c = 0; c < words; ++c) {
    float v[8];
    load8(src + 8 * c, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
  }
  absmax[blk] = m;
  const float inv = m > 0.f ? 1.0f / m : 0.f;

  int32_t* dst = wp + blk * words;
  for (int c = 0; c < words; ++c) {
    float v[8];
    load8(src + 8 * c, v);
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float norm = v[j] * inv;
      const uint32_t code = nf4 ? nf4_code(norm, mids) : fp4_code(norm);
      word |= code << (8 * (j / 2) + 4 - 4 * (j % 2));
    }
    dst[c] = static_cast<int32_t>(word);
  }
}

}  // namespace

// W [M, K] fp32 (w_is_bf16 = 0) or bf16 (1), contiguous and 16-byte
// aligned; K a multiple of blocksize, blocksize a multiple of 8.
// quant_type 0 = FP4, 1 = NF4 (mids: the 15 fp32 NF4 midpoints).
// Returns cudaGetLastError() after the launch.
extern "C" int qt_quantize_4bit(const void* W, int w_is_bf16,
                                const void* mids, void* wp, void* absmax,
                                int M, int K, int blocksize, int quant_type,
                                void* stream) {
  const long long nblocks = (long long)M * (K / blocksize);
  const unsigned grid = (unsigned)((nblocks + kThreads - 1) / kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  auto md = static_cast<const float*>(mids);
  auto out = static_cast<int32_t*>(wp);
  auto am = static_cast<float*>(absmax);
  if (w_is_bf16)
    quantize_4bit_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(W), md, out, am, nblocks,
        blocksize, quant_type);
  else
    quantize_4bit_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(W), md, out, am, nblocks, blocksize,
        quant_type);
  return static_cast<int>(cudaGetLastError());
}
