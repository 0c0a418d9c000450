// Planar 4-bit dequantize (kernel K7) for sm_90a.
//
// Replaces quantizations_tpu/ops/quantize.py:128 _dequantize_kernel,
// reached through dequantize_4bit_pallas (:192):
//
//   out[m, 8c + j] = dtype(table[code_j(wp[m, c])] * scale[m, c / 8])
//
// with the true fp32 codebook as the table and one IEEE fp32 product
// rounded to the output type (fp32, bf16 or fp16): bit-exact with the
// plain PyTorch version. The code of element j sits at bit
// 8*(j/2) + 4 - 4*(j%2) of its word (bnb byte order).
//
// Bound: bytes. Each word (4 bytes) becomes 8 outputs (32 bytes fp32, 16
// bf16), so the writes dominate: [14336, 4096] to fp32 moves 29.4 MB in
// and 234.9 MB out, 79 us at 3.35 TB/s. One thread a word, consecutive
// threads on consecutive words: the 4-byte loads and the 16- or 32-byte
// stores of a warp are contiguous. The table sits in shared memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
          << 16);
}

__device__ __forceinline__ uint32_t pack_f16(float a, float b) {
  return static_cast<uint32_t>(__half_as_ushort(__float2half_rn(a))) |
         (static_cast<uint32_t>(__half_as_ushort(__float2half_rn(b))) << 16);
}

// scale_kind: 0 = fp32, 1 = bf16; out_kind: 0 = fp32, 1 = bf16, 2 = fp16.
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int32_t* __restrict__ wp,
                  const void* __restrict__ scales, int scale_kind,
                  const float* __restrict__ table, void* __restrict__ out,
                  int out_kind, int M, int K8) {
  __shared__ float tbl[16];
  if (threadIdx.x < 16) tbl[threadIdx.x] = table[threadIdx.x];
  __syncthreads();

  const size_t n = (size_t)M * K8;
  const int NB = K8 / 8;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kThreads) {
    const uint32_t w = static_cast<uint32_t>(__ldg(wp + i));
    const size_t m = i / K8;
    const int c = static_cast<int>(i - m * K8);
    const size_t si = m * NB + (c >> 3);
    const float s =
        scale_kind == 0
            ? __ldg(static_cast<const float*>(scales) + si)
            : __bfloat162float(static_cast<const __nv_bfloat16*>(scales)[si]);
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = __fmul_rn(tbl[(w >> (8 * (j >> 1) + 4 - 4 * (j & 1))) & 15u], s);
    if (out_kind == 0) {
      float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + 8 * i);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      uint4 u;
      if (out_kind == 1)
        u = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                       pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
      else
        u = make_uint4(pack_f16(v[0], v[1]), pack_f16(v[2], v[3]),
                       pack_f16(v[4], v[5]), pack_f16(v[6], v[7]));
      reinterpret_cast<uint4*>(out)[i] = u;
    }
  }
}

}  // namespace

// out[M, 8*K8] = dequant(wp[M, K8], scales[M, K8/8]) in the original
// element order; K8 a multiple of 8, out 16-byte aligned (as torch.empty
// gives). Returns cudaGetLastError() after the launch.
extern "C" int qt_dequantize_4bit(const void* wp, const void* scales,
                                  int scale_kind, const void* table,
                                  void* out, int out_kind, int M, int K8,
                                  void* stream) {
  const size_t n = (size_t)M * K8;
  const size_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  dequantize_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(wp), scales, scale_kind,
      static_cast<const float*>(table), out, out_kind, M, K8);
  return static_cast<int>(cudaGetLastError());
}
