// Planar 4-bit dequantize (kernel K7) and pair-layout 4-bit dequantize
// (kernel K10) for sm_90a.
//
// K7 replaces quantizations_tpu/ops/quantize.py:128 _dequantize_kernel,
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
//
// K10 replaces the dequantize that quantizations_tpu/nn/linear.py:128
// dense_matmul_pair leaves to XLA (no Pallas site): pair words
// wp2[M/2, K/4] and scales to the dense [M, K] in the original row and
// column order, with the same product and rounding as K7. Its map is
// ops/qmatmul.py pair_column: of row pair i, word w = q*NB + b (NB = K/64,
// q in [0, 16)) holds columns 64b + 8(q % 8) + 4(q / 8) + p, p < 4, at
// nibble p of its low half (row 2i) and of its high half (row 2i + 1).
// Scales come as fp32 or bf16 [M, NB] or as bf16x2 words [M/2, NB] (row
// 2i in the low half), read as they are.
//
// Bound: bytes, the writes again (bf16: 4x the words' bytes). A block
// takes one row pair: its K/4 words and 2*NB scales go to shared memory
// with coalesced loads, the words as 16 rows q of NB, padded to a stride
// S = 4 (mod 32); then each thread writes 8 consecutive columns of one
// row (one E word q = c % 8 and one O word q = 8 + c % 8 of block c / 8),
// consecutive threads on consecutive chunks of the row pair's 2K
// contiguous outputs. A warp's 32 chunks read 4 blocks x 8 rows q, which
// the stride puts in 32 distinct banks.

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

// The row stride of K10's shared words: NB padded to 4 (mod 32).
__host__ __device__ constexpr int pair_stride(int NB) {
  return NB + (36 - NB % 32) % 32;
}

// scale_kind: 0 = fp32, 1 = bf16, 2 = bf16x2 words; out_kind as K7's.
__global__ void __launch_bounds__(kThreads)
dequantize_pair_kernel(const int32_t* __restrict__ wp2,
                       const void* __restrict__ scales, int scale_kind,
                       const float* __restrict__ table,
                       void* __restrict__ out, int out_kind, int K4) {
  extern __shared__ float smem[];   // 16 * S words, then 2 * NB scales
  __shared__ float tbl[16];
  const int K8 = K4 >> 1, NB = K4 >> 4, S = pair_stride(NB);
  uint32_t* sw = reinterpret_cast<uint32_t*>(smem);
  float* sc = smem + 16 * S;
  const size_t i = blockIdx.x;      // the row pair
  if (threadIdx.x < 16) tbl[threadIdx.x] = table[threadIdx.x];
  const int32_t* src = wp2 + i * K4;
  for (int w = threadIdx.x; w < K4; w += kThreads) {
    const int q = w / NB;
    sw[q * S + (w - q * NB)] = static_cast<uint32_t>(__ldg(src + w));
  }
  for (int j = threadIdx.x; j < 2 * NB; j += kThreads) {
    float s;                        // sc[h * NB + b]: row 2i + h, block b
    if (scale_kind == 0) {
      s = __ldg(static_cast<const float*>(scales) + 2 * i * NB + j);
    } else if (scale_kind == 1) {
      s = __bfloat162float(
          static_cast<const __nv_bfloat16*>(scales)[2 * i * NB + j]);
    } else {
      const int h = j >= NB;
      const uint32_t u = static_cast<uint32_t>(__ldg(
          static_cast<const int32_t*>(scales) + i * NB + (j - h * NB)));
      s = __uint_as_float(h ? (u & 0xFFFF0000u) : (u << 16));
    }
    sc[j] = s;
  }
  __syncthreads();

  // chunk f of the row pair: row 2i + h, columns 8c .. 8c + 7
  for (int f = threadIdx.x; f < K4; f += kThreads) {
    const int h = f >= K8;
    const int c = f - h * K8, r = c & 7, b = c >> 3;
    const uint32_t e = sw[r * S + b] >> (16 * h);
    const uint32_t o = sw[(8 + r) * S + b] >> (16 * h);
    const float s = sc[h * NB + b];
    float v[8];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      v[p] = __fmul_rn(tbl[(e >> (4 * p)) & 15u], s);
      v[4 + p] = __fmul_rn(tbl[(o >> (4 * p)) & 15u], s);
    }
    const size_t g = i * K4 + f;    // 16-byte chunk (bf16) of the output
    if (out_kind == 0) {
      float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + 8 * g);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else if (out_kind == 1) {
      reinterpret_cast<uint4*>(out)[g] =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                     pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    } else {
      reinterpret_cast<uint4*>(out)[g] =
          make_uint4(pack_f16(v[0], v[1]), pack_f16(v[2], v[3]),
                     pack_f16(v[4], v[5]), pack_f16(v[6], v[7]));
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


// out[2*M2, 4*K4] = dequant(wp2[M2, K4], scales) in the original row and
// column order; K4 a multiple of 16, out 16-byte aligned. One block of
// kThreads per row pair. Returns cudaGetLastError() after the launch.
extern "C" int qt_dequantize_4bit_pair(const void* wp2, const void* scales,
                                       int scale_kind, const void* table,
                                       void* out, int out_kind, int M2,
                                       int K4, void* stream) {
  const int NB = K4 / 16;
  const size_t smem = (16 * static_cast<size_t>(pair_stride(NB)) + 2 * NB) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dequantize_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dequantize_pair_kernel<<<M2, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(wp2), scales, scale_kind,
      static_cast<const float*>(table), out, out_kind, K4);
  return static_cast<int>(cudaGetLastError());
}
