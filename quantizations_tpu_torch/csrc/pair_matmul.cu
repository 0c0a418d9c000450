// Pair-layout 4-bit dequant + matmul for sm_90a: kernel K1 and, with the
// weight words streamed through shared memory, kernel K9.
//
// K1 replaces quantizations_tpu/ops/qmatmul.py:481 _pair_kernel, reached
// through matmul_4bit_pair_pallas (:588, the lm_head) and
// matmul_4bit_pair_pallas_stacked (:662, every projection; the stacked
// form passes this kernel a pointer to layer idx). K9 replaces the
// manual-pipeline body :1048 _manual_kernel_body, reached through
// matmul_4bit_pair_manual (:1103) and matmul_4bit_pair_manual_stacked
// (:1163).
//
//   y[t, m] = sum_k bf16(x[t, k]) * W[m, k]          (fp32 accumulation)
//   W[m, k] = bf16(table[code(m, k)] * s_bf)          (__hmul, RNE)
//   s_bf    = bf16(scale[m, k / 64]), then bf16(s_bf * bf16(out_factor))
//             when out_factor != 1 (FP4: table = raw codebook x 12,
//             out_factor = 1/12; NF4: table = bf16(codebook), factor 1)
//
// This is the TPU kernel's rounding class exactly; only the fp32
// summation order differs.
//
// Pair layout of wp2 [M/2, K/4]: word (i, w) holds row 2i at bits
// [4p, 4p+4) and row 2i+1 at [16+4p, 16+4p+4), p = 0..3. With
// NB = K/64 and w = r*NB + b (block-major): for w < K/8 the columns are
// 64b + 8r + p; in the second half (w - K/8 = r*NB + b) they are
// 64b + 8r + 4 + p. Word w's scale block is b = w mod NB.
//
// Bound: at decode (T <= 8) the weights dominate the bytes: the fused
// gate_up [28672, 4096] reads 58.7 MB of words + 7.3 MB of fp32 scales,
// 19.7 us at 3.35 TB/s. The design keeps every weight byte read once
// per token tile with coalesced 4-byte loads, and many warps in flight:
//  - a block of 16 warps owns 8 row pairs; two warps share a row pair,
//    each walking half of the NB blocks, so even M = 4096 gives 256
//    blocks (about two per SM);
//  - the K loop runs in 8 steps r = 0..7; step r needs columns
//    64b + 8r + 0..7 of every block b: 16 contiguous bytes per (token,
//    block), staged into shared memory once per step and read back
//    conflict-free (lane-consecutive 16-byte vectors);
//  - decode is a 16-entry bf16 table in shared memory (the SWAR bit
//    arithmetic of the TPU kernel works around a missing lane gather);
//  - a tile of TT <= 16 tokens lives in registers; T > 16 loops over
//    token tiles in blockIdx.x (fastest), so tiles of one row block run
//    together and re-read its weights from L2.
//
// K9 (kManual) is the same kernel with one change, the GPU form of the
// TPU kernel's two VMEM weight slots and DMA semaphores: step r's words
// (8 row pairs x 2 halves x NB words) arrive in a two-stage shared-memory
// ring filled with cp.async, step r + 1's copies in flight while step r
// decodes and accumulates. Every thread does the same arithmetic on the
// same words in the same order as K1, so K9's output is K1's bit for bit.
// (The TPU kernel's sequential M-chunk loop inside one program does not
// carry over: the grid covers M as K1's does.)
// Tensor cores (wgmma), TMA and deeper pipelines are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRowPairs = 8;                   // row pairs per block
constexpr int kWarpsPerPair = kWarps / kRowPairs;

// cp.async of 16 bytes (both addresses 16-byte aligned) or of 4 bytes.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ __nv_bfloat16 bf16_from_bits(uint32_t bits) {
  __nv_bfloat16_raw r;
  r.x = static_cast<unsigned short>(bits & 0xFFFFu);
  return __nv_bfloat16(r);
}

// scale_kind: 0 = fp32 [M, NB], 1 = bf16 [M, NB], 2 = bf16x2 int32 [M/2, NB]
// (row 2i in the low half).
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

// K9's ring: stage s holds step r's words of the block's 8 row pairs,
// [kRowPairs][2 halves][NB]; the row pair's words for step r are the NB
// contiguous words at r*NB (low half) and K/8 + r*NB (high half).
__device__ __forceinline__ void stream_words(uint32_t* stage,
                                             const int32_t* wp2, int pair0,
                                             int M2, int K4, int NB, int rs,
                                             bool vec) {
  const int K8 = K4 / 2;
  if (vec) {                                     // NB % 4 == 0, aligned
    const int nv = NB / 4;
    for (int q = threadIdx.x; q < kRowPairs * 2 * nv; q += kThreads) {
      const int ph = q / nv, c = q - ph * nv;    // ph = pair * 2 + half
      const int i = pair0 + ph / 2;
      if (i < M2)
        cp_async16(stage + ph * NB + 4 * c,
                   wp2 + (size_t)i * K4 + (ph & 1) * K8 + rs * NB + 4 * c);
    }
  } else {
    for (int q = threadIdx.x; q < kRowPairs * 2 * NB; q += kThreads) {
      const int ph = q / NB, b = q - ph * NB;
      const int i = pair0 + ph / 2;
      if (i < M2)
        cp_async4(stage + ph * NB + b,
                  wp2 + (size_t)i * K4 + (ph & 1) * K8 + rs * NB + b);
    }
  }
}

template <int TT, bool kManual>
__global__ void __launch_bounds__(kThreads)
pair_matmul_kernel(const int32_t* __restrict__ wp2,
                   const void* __restrict__ scales, int scale_kind,
                   const __nv_bfloat16* __restrict__ table,
                   const __nv_bfloat16* __restrict__ x,
                   float* __restrict__ y, int T, int M2, int K4,
                   int has_factor, float factor, int vec) {
  extern __shared__ uint4 xs[];                  // [TT][NB] x 8 bf16,
                                                 // then K9's 2 stages
  __shared__ __nv_bfloat16 tbl[16];
  __shared__ float red[kWarps][2][TT];

  const int NB = K4 / 16;
  const int K8 = K4 / 2;
  const int K = 4 * K4;
  const int M = 2 * M2;
  const int t0 = blockIdx.x * TT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pair_slot = warp % kRowPairs;
  const int part = warp / kRowPairs;             // which half of the blocks
  const int i = blockIdx.y * kRowPairs + pair_slot;
  const bool row_ok = i < M2;
  const __nv_bfloat16 fac = __float2bfloat16_rn(factor);

  if (threadIdx.x < 16) tbl[threadIdx.x] = table[threadIdx.x];

  float acc[2][TT];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[h][t] = 0.f;

  const int32_t* wrow = wp2 + (size_t)(row_ok ? i : 0) * K4;
  uint32_t* ring = reinterpret_cast<uint32_t*>(xs + TT * NB);
  const int stage_words = kRowPairs * 2 * NB;
  if (kManual) {
    stream_words(ring, wp2, blockIdx.y * kRowPairs, M2, K4, NB, 0, vec);
    cp_async_commit();
  }

  for (int rs = 0; rs < 8; ++rs) {
    __syncthreads();   // previous step's reads of xs (and of K9's stage
                       // (rs + 1) & 1) are done
    if (kManual) {     // step rs + 1's words in flight during step rs
      if (rs + 1 < 8)
        stream_words(ring + ((rs + 1) & 1) * stage_words, wp2,
                     blockIdx.y * kRowPairs, M2, K4, NB, rs + 1, vec);
      cp_async_commit();
    }
    for (int q = threadIdx.x; q < TT * NB; q += kThreads) {
      const int t = q / NB, b = q - (q / NB) * NB;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t0 + t < T)
        v = __ldg(reinterpret_cast<const uint4*>(
            x + (size_t)(t0 + t) * K + 64 * b + 8 * rs));
      xs[q] = v;
    }
    if (kManual) cp_async_wait_prev();           // step rs's words landed
    __syncthreads();
    if (!row_ok) continue;
    const uint32_t* words =
        ring + (rs & 1) * stage_words + pair_slot * 2 * NB;

#pragma unroll 2
    for (int b = part * 32 + lane; b < NB; b += 32 * kWarpsPerPair) {
      uint32_t w_lo, w_hi;
      if (kManual) {
        w_lo = words[b];
        w_hi = words[NB + b];
      } else {
        w_lo = static_cast<uint32_t>(__ldg(wrow + rs * NB + b));
        w_hi = static_cast<uint32_t>(__ldg(wrow + K8 + rs * NB + b));
      }
      __nv_bfloat16 s0, s1;
      load_scales(scales, scale_kind, i, b, NB, s0, s1);
      if (has_factor) {
        s0 = __hmul(s0, fac);
        s1 = __hmul(s1, fac);
      }
      // weights of rows 2i (we) and 2i+1 (wo) at columns 64b + 8rs + j
      float we[8], wo[8];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        we[p] = __bfloat162float(__hmul(tbl[(w_lo >> (4 * p)) & 15u], s0));
        wo[p] =
            __bfloat162float(__hmul(tbl[(w_lo >> (16 + 4 * p)) & 15u], s1));
        we[4 + p] =
            __bfloat162float(__hmul(tbl[(w_hi >> (4 * p)) & 15u], s0));
        wo[4 + p] =
            __bfloat162float(__hmul(tbl[(w_hi >> (16 + 4 * p)) & 15u], s1));
      }
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        const uint4 v = xs[t * NB + b];
        const uint32_t u[4] = {v.x, v.y, v.z, v.w};
        float ae = acc[0][t], ao = acc[1][t];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float xa = __uint_as_float(u[c] << 16);          // col 2c
          const float xb = __uint_as_float(u[c] & 0xFFFF0000u);  // col 2c+1
          ae = fmaf(xa, we[2 * c], ae);
          ao = fmaf(xa, wo[2 * c], ao);
          ae = fmaf(xb, we[2 * c + 1], ae);
          ao = fmaf(xb, wo[2 * c + 1], ao);
        }
        acc[0][t] = ae;
        acc[1][t] = ao;
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      float v = acc[h][t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][h][t] = v;
    }
  __syncthreads();
  for (int q = threadIdx.x; q < kRowPairs * 2 * TT; q += kThreads) {
    const int slot = q / (2 * TT);
    const int h = (q / TT) % 2;
    const int t = q % TT;
    const int row_pair = blockIdx.y * kRowPairs + slot;
    if (row_pair >= M2 || t0 + t >= T) continue;
    float v = 0.f;
    for (int pw = 0; pw < kWarpsPerPair; ++pw)
      v += red[pw * kRowPairs + slot][h][t];
    y[(size_t)(t0 + t) * M + 2 * row_pair + h] = v;
  }
}

template <int TT, bool kManual>
cudaError_t launch_tt(const int32_t* wp2, const void* scales, int scale_kind,
                      const __nv_bfloat16* table, const __nv_bfloat16* x,
                      float* y, int T, int M2, int K4, int has_factor,
                      float factor, cudaStream_t stream) {
  const int NB = K4 / 16;
  size_t smem = (size_t)TT * NB * sizeof(uint4);
  if (kManual) smem += 2 * (size_t)kRowPairs * 2 * NB * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pair_matmul_kernel<TT, kManual>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  // 16-byte copies need NB % 4 == 0 and a 16-byte aligned layer
  const int vec = NB % 4 == 0 && reinterpret_cast<uintptr_t>(wp2) % 16 == 0;
  dim3 grid((T + TT - 1) / TT, (M2 + kRowPairs - 1) / kRowPairs);
  pair_matmul_kernel<TT, kManual><<<grid, kThreads, smem, stream>>>(
      wp2, scales, scale_kind, table, x, y, T, M2, K4, has_factor, factor,
      vec);
  return cudaGetLastError();
}

template <bool kManual>
int launch_pair(const void* wp2, const void* scales, int scale_kind,
                const void* table, const void* x, void* y, int T, int M2,
                int K4, int has_factor, float factor, void* stream) {
  auto w = static_cast<const int32_t*>(wp2);
  auto tb = static_cast<const __nv_bfloat16*>(table);
  auto xx = static_cast<const __nv_bfloat16*>(x);
  auto yy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (T <= 1)
    e = launch_tt<1, kManual>(w, scales, scale_kind, tb, xx, yy, T, M2, K4,
                              has_factor, factor, st);
  else if (T <= 2)
    e = launch_tt<2, kManual>(w, scales, scale_kind, tb, xx, yy, T, M2, K4,
                              has_factor, factor, st);
  else if (T <= 4)
    e = launch_tt<4, kManual>(w, scales, scale_kind, tb, xx, yy, T, M2, K4,
                              has_factor, factor, st);
  else if (T <= 8)
    e = launch_tt<8, kManual>(w, scales, scale_kind, tb, xx, yy, T, M2, K4,
                              has_factor, factor, st);
  else
    e = launch_tt<16, kManual>(w, scales, scale_kind, tb, xx, yy, T, M2, K4,
                               has_factor, factor, st);
  return static_cast<int>(e);
}

}  // namespace

// y[T, 2*M2] fp32 = x[T, 4*K4] bf16 . dequant(wp2[M2, K4], scales)^T.
// K4 must be a multiple of 16 (K a multiple of 64); pointers to x are
// 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int qt_pair_matmul(const void* wp2, const void* scales,
                              int scale_kind, const void* table,
                              const void* x, void* y, int T, int M2, int K4,
                              int has_factor, float factor, void* stream) {
  return launch_pair<false>(wp2, scales, scale_kind, table, x, y, T, M2, K4,
                            has_factor, factor, stream);
}

// K9: the same product, bit-identical to qt_pair_matmul, with the weight
// words streamed through the shared-memory ring.
extern "C" int qt_pair_manual(const void* wp2, const void* scales,
                              int scale_kind, const void* table,
                              const void* x, void* y, int T, int M2, int K4,
                              int has_factor, float factor, void* stream) {
  return launch_pair<true>(wp2, scales, scale_kind, table, x, y, T, M2, K4,
                           has_factor, factor, stream);
}
