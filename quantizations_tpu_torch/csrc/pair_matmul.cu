// Pair-layout 4-bit dequant + matmul for sm_90a: kernel K1's CUDA-core
// body and kernel K9, one body behind two entry points. K1 runs it below
// ops/qmatmul.py PAIR_SPLITK_MIN_TOKENS (3) token rows, its split-K
// tensor-core body (csrc/pair_splitk.cu) from there up to 128 rows and
// K8's tensor-core body (csrc/pair_prefill.cu) above; K9 picks its body
// by the same rule (pair_body), so this body serves K9 at 1 and 2 rows.
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
// 19.7 us at 3.35 TB/s. The body reads every weight byte once per token
// tile with coalesced 16-byte copies, and no step waits on a global load:
//  - a block of 16 warps owns 8 row pairs; two warps share a row pair,
//    lane l of warp part p taking the scale blocks b = 32p + l (mod 64),
//    so even M = 4096 gives 256 blocks;
//  - the K loop runs over sub-steps (r, c): step r = 0..7 needs columns
//    64b + 8r + 0..7 of every block b, chunk c the blocks [64c, 64c + 64).
//    A sub-step's operands, 16 bytes of activations per (token, block)
//    and two weight words per (row pair, block), arrive through a
//    4-stage cp.async ring of fixed-size stages ((TT + 4) KB at any K),
//    three sub-steps in flight while one is decoded and accumulated;
//    token rows at or past T are zero-filled; one barrier per sub-step;
//  - the block's scales are read once, rounded to bf16 (and multiplied
//    by bf16(out_factor)), and kept in shared memory as (row 2i, row
//    2i+1) pairs;
//  - decode is a 16-entry bf16 table in shared memory (the SWAR bit
//    arithmetic of the TPU kernel works around a missing lane gather);
//  - a tile of TT <= 16 tokens lives in registers; T > 16 loops over
//    token tiles in blockIdx.x (fastest), so tiles of one row block run
//    together and re-read its weights from L2;
//  - up to TT = 4 the block is held to 64 registers, two blocks per SM,
//    without spills; at TT = 8 that cap spills, so TT >= 8 takes what it
//    needs at one block per SM.
// Each lane sums in fp32 over the steps r, then over its blocks b in
// ascending order, then across the warp (shuffle tree) and the two warps
// of its row pair: the sum order does not depend on the ring.
//
// K9 is the GPU form of the TPU kernel's two VMEM weight slots and DMA
// semaphores: its weight words stream through the ring. K1's do too, so
// both entry points launch this one body and K9's output is K1's bit for
// bit. (The TPU kernel's sequential M-chunk loop inside one program does
// not carry over: the grid covers M.)
//
// What sets the pace is no longer the loads but the instructions per
// weight (table decode, bf16 product, fp32 products per token row). From
// 3 rows on the tensor cores take the products (csrc/pair_splitk.cu);
// TMA for the ring and a cheaper decode are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRowPairs = 8;                   // row pairs per block
constexpr int kWarpsPerPair = kWarps / kRowPairs;
constexpr int kChunk = 32 * kWarpsPerPair;     // scale blocks per sub-step
constexpr int kStages = 4;
constexpr int kMaxDevices = 64;

// One ring stage in 16-byte units: activations [TT][kChunk], then the
// words [kRowPairs][2 halves][kChunk].
__host__ __device__ constexpr int stage_vecs(int TT) {
  return TT * kChunk + kRowPairs * 2 * kChunk / 4;
}

// cp.async of 16 bytes (both addresses 16-byte aligned) or of 4 bytes;
// the zero-filling form writes 16 zero bytes when !live.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = live ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// Start the copies of sub-step (rs, c) into one ring stage: x[t0 + t,
// 64b + 8rs .. + 8] and the words r*NB + b of both halves of the block's
// row pairs, for the blocks b of chunk c. Blocks past NB and row pairs
// past M2 are not copied (and not read).
template <int TT>
__device__ __forceinline__ void fetch_substep(
    uint4* stage, const int32_t* wp2, const __nv_bfloat16* x, int pair0,
    int M2, int K4, int NB, int T, int t0, int rs, int c, bool vec) {
  const int K8 = K4 / 2;
  const int K = 4 * K4;
  const int b0 = c * kChunk;
  for (int q = threadIdx.x; q < TT * kChunk; q += kThreads) {
    const int t = q / kChunk, b = b0 + q % kChunk;
    if (b < NB) {
      const bool live = t0 + t < T;
      cp_async16_zfill(stage + q,
                       x + (size_t)(live ? t0 + t : 0) * K + 64 * b + 8 * rs,
                       live);
    }
  }
  uint32_t* words = reinterpret_cast<uint32_t*>(stage + TT * kChunk);
  if (vec) {                                     // NB % 4 == 0, aligned
    constexpr int nv = kChunk / 4;
    for (int q = threadIdx.x; q < kRowPairs * 2 * nv; q += kThreads) {
      const int ph = q / nv, v = q - ph * nv;    // ph = pair * 2 + half
      const int i = pair0 + ph / 2, b = b0 + 4 * v;
      if (i < M2 && b < NB)
        cp_async16(words + ph * kChunk + 4 * v,
                   wp2 + (size_t)i * K4 + (ph & 1) * K8 + rs * NB + b);
    }
  } else {
    for (int q = threadIdx.x; q < kRowPairs * 2 * kChunk; q += kThreads) {
      const int ph = q / kChunk, v = q - ph * kChunk;
      const int i = pair0 + ph / 2, b = b0 + v;
      if (i < M2 && b < NB)
        cp_async4(words + q,
                  wp2 + (size_t)i * K4 + (ph & 1) * K8 + rs * NB + b);
    }
  }
}

template <int TT>
__global__ void __launch_bounds__(kThreads, TT <= 4 ? 2 : 1)
pair_matmul_kernel(const int32_t* __restrict__ wp2,
                   const void* __restrict__ scales, int scale_kind,
                   const __nv_bfloat16* __restrict__ table,
                   const __nv_bfloat16* __restrict__ x,
                   float* __restrict__ y, int T, int M2, int K4,
                   int has_factor, float factor, int vec) {
  extern __shared__ uint4 ring[];                // kStages stages, then
                                                 // the scales [8][NB]
  __shared__ __nv_bfloat16 tbl[16];
  __shared__ float red[kWarps][2][TT];

  constexpr int SV = stage_vecs(TT);
  const int NB = K4 / 16;
  const int NC = (NB + kChunk - 1) / kChunk;     // chunks per step
  const int M = 2 * M2;
  const int t0 = blockIdx.x * TT;
  const int pair0 = blockIdx.y * kRowPairs;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pair_slot = warp % kRowPairs;
  const int part = warp / kRowPairs;             // which half of a chunk
  const int col = part * 32 + lane;              // block c * kChunk + col
  const bool row_ok = pair0 + pair_slot < M2;
  uint32_t* sc = reinterpret_cast<uint32_t*>(ring + kStages * SV);

  if (threadIdx.x < 16) tbl[threadIdx.x] = table[threadIdx.x];

  // sub-steps 0 .. kStages - 2 in flight; (irs, ic) is the next to fetch
  int irs = 0, ic = 0;
  for (int s = 0; s < kStages - 1; ++s) {
    if (irs < 8)
      fetch_substep<TT>(ring + s * SV, wp2, x, pair0, M2, K4, NB, T, t0, irs,
                        ic, vec);
    cp_async_commit();
    if (++ic == NC) { ic = 0; ++irs; }
  }

  // the block's scales, rounded once, while the first copies land
  const __nv_bfloat16 fac = __float2bfloat16_rn(factor);
  for (int q = threadIdx.x; q < kRowPairs * NB; q += kThreads) {
    const int p = q / NB, b = q - p * NB;
    if (pair0 + p < M2) {
      __nv_bfloat16 s0, s1;
      load_scales(scales, scale_kind, pair0 + p, b, NB, s0, s1);
      if (has_factor) {
        s0 = __hmul(s0, fac);
        s1 = __hmul(s1, fac);
      }
      sc[q] = static_cast<uint32_t>(__bfloat16_as_ushort(s0)) |
              (static_cast<uint32_t>(__bfloat16_as_ushort(s1)) << 16);
    }
  }

  float acc[2][TT];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[h][t] = 0.f;

  int stage = 0, c = 0;                          // the sub-step computed
  for (int u = 0; u < 8 * NC; ++u) {
    cp_async_wait<kStages - 2>();                // sub-step u landed ...
    __syncthreads();   // ... for every thread; sub-step u - 1's stage is
                       // free: refill it with sub-step u + kStages - 1
    if (irs < 8) {
      int st = stage + kStages - 1;
      if (st >= kStages) st -= kStages;
      fetch_substep<TT>(ring + st * SV, wp2, x, pair0, M2, K4, NB, T, t0, irs,
                        ic, vec);
    }
    cp_async_commit();
    if (++ic == NC) { ic = 0; ++irs; }

    const int b = c * kChunk + col;
    if (row_ok && b < NB) {
      const uint4* xs = ring + stage * SV;
      const uint32_t* words =
          reinterpret_cast<const uint32_t*>(xs + TT * kChunk) +
          pair_slot * 2 * kChunk;
      const uint32_t w_lo = words[col];
      const uint32_t w_hi = words[kChunk + col];
      const uint32_t sv = sc[pair_slot * NB + b];
      const __nv_bfloat16 s0 = bf16_from_bits(sv);
      const __nv_bfloat16 s1 = bf16_from_bits(sv >> 16);
      // weights of rows 2i (we) and 2i+1 (wo) at columns 64b + 8r + j
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
        const uint4 v = xs[t * kChunk + col];
        const uint32_t xu[4] = {v.x, v.y, v.z, v.w};
        float ae = acc[0][t], ao = acc[1][t];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float xa = __uint_as_float(xu[k] << 16);          // col 2k
          const float xb = __uint_as_float(xu[k] & 0xFFFF0000u);  // 2k+1
          ae = fmaf(xa, we[2 * k], ae);
          ao = fmaf(xa, wo[2 * k], ao);
          ae = fmaf(xb, we[2 * k + 1], ae);
          ao = fmaf(xb, wo[2 * k + 1], ao);
        }
        acc[0][t] = ae;
        acc[1][t] = ao;
      }
    }
    if (++c == NC) c = 0;
    if (++stage == kStages) stage = 0;
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
    const int row_pair = pair0 + slot;
    if (row_pair >= M2 || t0 + t >= T) continue;
    float v = 0.f;
    for (int pw = 0; pw < kWarpsPerPair; ++pw)
      v += red[pw * kRowPairs + slot][h][t];
    y[(size_t)(t0 + t) * M + 2 * row_pair + h] = v;
  }
}

// Allow pair_matmul_kernel<TT> all the dynamic shared memory the device
// gives one block, once per instantiation and device.
template <int TT>
cudaError_t allow_smem() {
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kMaxDevices && allowed[dev])) return e;
  int optin = 0;
  cudaFuncAttributes fa;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, pair_matmul_kernel<TT>);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(pair_matmul_kernel<TT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(fa.sharedSizeBytes));
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = true;
  return e;
}

template <int TT>
cudaError_t launch_tt(const int32_t* wp2, const void* scales, int scale_kind,
                      const __nv_bfloat16* table, const __nv_bfloat16* x,
                      float* y, int T, int M2, int K4, int has_factor,
                      float factor, cudaStream_t stream) {
  const int NB = K4 / 16;
  const size_t smem = (size_t)kStages * stage_vecs(TT) * sizeof(uint4) +
                      (size_t)kRowPairs * NB * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem<TT>();
    if (e != cudaSuccess) return e;
  }
  // 16-byte word copies need NB % 4 == 0 and a 16-byte aligned layer
  const int vec = NB % 4 == 0 && reinterpret_cast<uintptr_t>(wp2) % 16 == 0;
  dim3 grid((T + TT - 1) / TT, (M2 + kRowPairs - 1) / kRowPairs);
  pair_matmul_kernel<TT><<<grid, kThreads, smem, stream>>>(
      wp2, scales, scale_kind, table, x, y, T, M2, K4, has_factor, factor,
      vec);
  return cudaGetLastError();
}

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
    e = launch_tt<1>(w, scales, scale_kind, tb, xx, yy, T, M2, K4, has_factor,
                     factor, st);
  else if (T <= 2)
    e = launch_tt<2>(w, scales, scale_kind, tb, xx, yy, T, M2, K4, has_factor,
                     factor, st);
  else if (T <= 4)
    e = launch_tt<4>(w, scales, scale_kind, tb, xx, yy, T, M2, K4, has_factor,
                     factor, st);
  else if (T <= 8)
    e = launch_tt<8>(w, scales, scale_kind, tb, xx, yy, T, M2, K4, has_factor,
                     factor, st);
  else
    e = launch_tt<16>(w, scales, scale_kind, tb, xx, yy, T, M2, K4,
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
  return launch_pair(wp2, scales, scale_kind, table, x, y, T, M2, K4,
                     has_factor, factor, stream);
}

// K9: the same body, so bit-identical to qt_pair_matmul; the weight words
// stream through the ring as the TPU kernel's manual pipeline streams
// them through its VMEM slots.
extern "C" int qt_pair_manual(const void* wp2, const void* scales,
                              int scale_kind, const void* table,
                              const void* x, void* y, int T, int M2, int K4,
                              int has_factor, float factor, void* stream) {
  return launch_pair(wp2, scales, scale_kind, table, x, y, T, M2, K4,
                     has_factor, factor, stream);
}
