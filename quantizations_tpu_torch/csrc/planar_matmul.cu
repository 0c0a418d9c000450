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
// per token tile with 16-byte copies, and no K step waits on a global
// load:
//  - a block of 8 warps owns 16 rows, two per warp; lane l of a warp
//    takes words 4l..4l+3 of each of its rows in a 128-word K step, so
//    the 4 words lie in one quant block;
//  - a step's words (512 contiguous bytes a row) and the 4-byte words
//    that hold their 16 scales a row come through a cp.async ring of two
//    9 KB stages: the next step's copies fly while a step is decoded,
//    one barrier a step. Two stages beat three and four on an H100: the
//    smaller ring leaves room for more blocks an SM;
//  - the token tile's activations go through registers one step ahead
//    (__ldg of 16-byte chunks, zeros past T and K8) into fp32 planes
//    xs[t][j][c] = x[t, 8c + j], double-buffered: a lane reads one
//    float4 per (t, j) for its 4 words, conflict-free, and the two rows of
//    a warp share it;
//  - the 16-entry decode table sits in shared memory;
//  - K6 sums a quant block's 64 products over the lane pair that holds it
//    (one shuffle), then scales; K5 scales every weight before its
//    product, as the TPU kernel does.
// Each lane's fp32 order is that of the body before the ring: per
// accumulator, the step's planes j in order, then its words q; K6's pair
// sum times the scale per step; the same shuffle tree at the end. So the
// output is that body's bit for bit, at any token tile.
// A tile of TT <= 8 tokens lives in registers (3 for K6 at three tokens,
// else 1, 2, 4 or 8); larger T loops over token tiles in blockIdx.x
// (fastest), so the tiles of one row block run together and re-read its
// words from L2. This CUDA-core body is K5's below PLANAR_MMA_MIN_TOKENS
// rows and all of K6; K5's tensor-core body (mma.sync, a cp.async ring a
// warp) is at the end of the file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;   // rows per block
constexpr int kStep = 128;                     // words per K step
constexpr int kStepBlocks = kStep / 8;         // quant blocks per K step
constexpr int kStages = 2;
constexpr int kMaxDevices = 64;
// A ring stage: the block's words [kRows][kStep], then the 4-byte words
// that hold their scales [kRows][kStepBlocks].
constexpr int kWordBytes = kRows * kStep * 4;
constexpr int kStageBytes = kWordBytes + kRows * kStepBlocks * 4;
// 16-byte word copies a thread makes a step
constexpr int kWordCopies = kRows * kStep / 4 / kThreads;
static_assert(kWordCopies * kThreads == kRows * kStep / 4, "whole copies");
static_assert(kRows * kStepBlocks <= kThreads, "one scale copy a thread");

// Dynamic shared memory: the ring, then the fp32 planes [2][TT][8][kStep].
__host__ __device__ constexpr size_t smem_bytes(int TT) {
  return (size_t)kStages * kStageBytes +
         (size_t)2 * TT * 8 * kStep * sizeof(float);
}

// cp.async of 16 or 4 bytes; zeros when !ok (both bodies of this file).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xFFFF0000u);
}

// Blocks an SM holds at once (the register cap, 65536 / (kThreads x
// blocks)), as high as the tile goes without spills: the fp32 activations
// held a step ahead take twice the registers of bf16 ones.
__host__ __device__ constexpr int min_blocks(int TT, int XB) {
  return TT <= 2 ? 4 : XB == 2 ? (TT <= 4 ? 3 : 2) : (TT <= 3 ? 2 : 1);
}

// kBf16 selects K5's class, else K6's; XB is the activation's size in
// bytes (2: bf16, 4: fp32; K5 takes bf16 only).
template <int TT, bool kBf16, int XB>
__global__ void __launch_bounds__(kThreads, min_blocks(TT, XB))
planar_kernel(const int32_t* __restrict__ wp, const void* __restrict__ scales,
              int scale_kind, const float* __restrict__ table,
              const void* __restrict__ x, float* __restrict__ y, int T, int M,
              int K8, int has_factor, float factor) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float tbl[16];

  const int NB = K8 / 8;
  const size_t K = 8 * (size_t)K8;
  const int nsteps = (K8 + kStep - 1) / kStep;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TT;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row_blk = blockIdx.y * kRows;
  const int row0 = row_blk + warp * kRowsPerWarp;
  float* planes = reinterpret_cast<float*>(smem + kStages * kStageBytes);

  // This thread's ring copies of a step, fixed but for the step's offset:
  // words 4wc..4wc+3 of rows wr, wr + kWr, ...; the (aligned 4-byte word
  // holding the) scale of quant block sb of row sr
  constexpr int kWr = kThreads / (kStep / 4);
  const int wr = tid / (kStep / 4), wc = tid % (kStep / 4);
  const int32_t* wsrc =
      wp + (row_blk + wr < M ? (size_t)(row_blk + wr) * K8 : 0) + 4 * wc;
  const int sr = tid / kStepBlocks, sb = tid % kStepBlocks;
  const bool s_row = row_blk + sr < M;
  const int s_size = scale_kind == 0 ? 4 : 2;
  const uintptr_t ssrc =
      reinterpret_cast<uintptr_t>(scales) +
      (s_row ? (size_t)(row_blk + sr) * NB * s_size : 0) + sb * s_size;
  // bf16 scales: which half of its word holds scale (m, b)
  const unsigned s_half0 =
      static_cast<unsigned>(reinterpret_cast<uintptr_t>(scales) >> 1);

  auto fetch = [&](int u) {
    unsigned char* stage = smem + (u % kStages) * kStageBytes;
    const int c0 = u * kStep;
    if (4 * wc + c0 < K8) {                        // K8 % 4 == 0
#pragma unroll
      for (int k = 0; k < kWordCopies; ++k)
        if (row_blk + wr + k * kWr < M)
          cp_async16(stage + 16 * (tid + k * kThreads),
                     wsrc + (size_t)k * kWr * K8 + c0, true);
    }
    if (tid < kRows * kStepBlocks && s_row && c0 / 8 + sb < NB)
      cp_async4(stage + kWordBytes + 4 * tid,
                reinterpret_cast<const void*>(
                    (ssrc + (size_t)(c0 / 8) * s_size) &
                    ~static_cast<uintptr_t>(3)),
                true);
  };

  // The activations go to fp32 planes[p][t][j][c] = x[t0 + t, 8(c0 + c) +
  // j] through registers, one step ahead: this thread's 16-byte chunks q =
  // tid + k kThreads of the tile's step (a chunk is the 8 values of one
  // word column in bf16, half of them in fp32); zeros past T and K8.
  constexpr int kTokChunks = kStep * XB / 2;      // a token's chunks a step
  constexpr int kXc = (TT * kTokChunks + kThreads - 1) / kThreads;
  const unsigned char* x8 = static_cast<const unsigned char*>(x);
  uint4 xr[kXc];
  auto load_x = [&](int u) {
    const int c0 = u * kStep;
#pragma unroll
    for (int k = 0; k < kXc; ++k) {
      const int q = tid + k * kThreads;
      const int t = q / kTokChunks, i = q % kTokChunks;
      const int c = i / (XB / 2);
      xr[k] = make_uint4(0u, 0u, 0u, 0u);
      if (q < TT * kTokChunks && t0 + t < T && c0 + c < K8)
        xr[k] = __ldg(reinterpret_cast<const uint4*>(
            x8 + ((t0 + t) * K + 8 * (size_t)(c0 + c)) * XB +
            16 * (i % (XB / 2))));
    }
  };
  auto store_x = [&](int p) {
    float* pl = planes + p * TT * 8 * kStep;
#pragma unroll
    for (int k = 0; k < kXc; ++k) {
      const int q = tid + k * kThreads;
      if (q >= TT * kTokChunks) break;
      const int t = q / kTokChunks, i = q % kTokChunks;
      const int c = i / (XB / 2), j0 = 4 * (i % (XB / 2));
      const uint32_t v[4] = {xr[k].x, xr[k].y, xr[k].z, xr[k].w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        if (XB == 2) {
          pl[(t * 8 + 2 * h) * kStep + c] = bf16_lo(v[h]);
          pl[(t * 8 + 2 * h + 1) * kStep + c] = bf16_hi(v[h]);
        } else {
          pl[(t * 8 + j0 + h) * kStep + c] = __uint_as_float(v[h]);
        }
      }
    }
  };

  // steps 0 .. kStages - 2 in flight
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) fetch(s);
    cp_async_commit();
  }
  if (tid < 16) tbl[tid] = table[tid];
  load_x(0);
  store_x(0);
  if (nsteps > 1) load_x(1);

  const __nv_bfloat16 fac = __float2bfloat16_rn(factor);
  float acc[kRowsPerWarp][TT];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[r][t] = 0.f;

  for (int u = 0; u < nsteps; ++u) {
    cp_async_wait<kStages - 2>();     // step u landed for this thread ...
    __syncthreads();   // ... and every thread, and planes[u & 1] hold its
                       // activations; step u - 1's stage and planes are
                       // free: refill the stage with step u + kStages - 1,
                       // the planes with step u + 1
    if (u + kStages - 1 < nsteps) fetch(u + kStages - 1);
    cp_async_commit();
    if (u + 1 < nsteps) {
      store_x((u + 1) & 1);
      if (u + 2 < nsteps) load_x(u + 2);
    }

    const unsigned char* stage = smem + (u % kStages) * kStageBytes;
    const uint32_t* s_words =
        reinterpret_cast<const uint32_t*>(stage + kWordBytes);
    const float* xs = planes + (u & 1) * TT * 8 * kStep;
    const int cw = u * kStep + 4 * lane;          // this lane's first word
    uint32_t w[kRowsPerWarp][4];
    float s[kRowsPerWarp];
    bool ok[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int rl = warp * kRowsPerWarp + r;    // row in the block
      ok[r] = cw < K8 && row0 + r < M;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      s[r] = 0.f;
      if (ok[r]) {
        v = *reinterpret_cast<const uint4*>(stage + 4 * rl * kStep +
                                            16 * lane);
        // the scale of quant block cw / 8 (slot lane / 2 of the step): K5
        // rounds it to bf16 (times bf16(factor)), K6 takes it in fp32
        const uint32_t sw = s_words[rl * kStepBlocks + (lane >> 1)];
        __nv_bfloat16 sbf;
        float sf;
        if (scale_kind == 0) {
          sf = __uint_as_float(sw);
          sbf = __float2bfloat16_rn(sf);
        } else {
          const unsigned half =
              (s_half0 + (unsigned)(row0 + r) * (unsigned)NB +
               (unsigned)(cw >> 3)) & 1u;
          __nv_bfloat16_raw raw;
          raw.x = static_cast<unsigned short>(sw >> (16 * half));
          sbf = __nv_bfloat16(raw);
          sf = __bfloat162float(sbf);
        }
        if (kBf16) {
          if (has_factor) sbf = __hmul(sbf, fac);
          sf = __bfloat162float(sbf);
        }
        s[r] = sf;
      }
      w[r][0] = v.x;
      w[r][1] = v.y;
      w[r][2] = v.z;
      w[r][3] = v.w;
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

// Allow planar_kernel<TT, kBf16, XB> all the dynamic shared memory the
// device gives one block, once per instantiation and device.
template <int TT, bool kBf16, int XB>
cudaError_t allow_smem() {
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kMaxDevices && allowed[dev])) return e;
  int optin = 0;
  cudaFuncAttributes fa;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&fa, planar_kernel<TT, kBf16, XB>);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(planar_kernel<TT, kBf16, XB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(fa.sharedSizeBytes));
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = true;
  return e;
}

template <int TT, bool kBf16, int XB>
cudaError_t launch_tt(const int32_t* wp, const void* scales, int scale_kind,
                      const float* table, const void* x, float* y, int T,
                      int M, int K8, int has_factor, float factor,
                      cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(TT);
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem<TT, kBf16, XB>();
    if (e != cudaSuccess) return e;
  }
  dim3 grid((T + TT - 1) / TT, (M + kRows - 1) / kRows);
  planar_kernel<TT, kBf16, XB><<<grid, kThreads, smem, stream>>>(
      wp, scales, scale_kind, table, x, y, T, M, K8, has_factor, factor);
  return cudaGetLastError();
}

// The token tile for T tokens: 1, 2, 4 or 8, and 3 for K6 (B = 3 decode);
// larger T loops over tiles of 8 in blockIdx.x.
template <bool kBf16, int XB>
cudaError_t launch_planar(const void* wp, const void* scales, int scale_kind,
                          const void* table, const void* x, void* y, int T,
                          int M, int K8, int has_factor, float factor,
                          void* stream) {
  auto w = static_cast<const int32_t*>(wp);
  auto tb = static_cast<const float*>(table);
  auto yy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
#define QT_TT(TT_)                                                           \
  launch_tt<TT_, kBf16, XB>(w, scales, scale_kind, tb, x, yy, T, M, K8,     \
                            has_factor, factor, st)
  if (T <= 1) return QT_TT(1);
  if (T <= 2) return QT_TT(2);
  if constexpr (!kBf16)
    if (T == 3) return QT_TT(3);
  if (T <= 4) return QT_TT(4);
  return QT_TT(8);
#undef QT_TT
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
  return static_cast<int>(launch_planar<true, 2>(
      wp, scales, scale_kind, table, x, y, T, M, K8, has_factor, factor,
      stream));
}

// K6: y[T, M] fp32 = x[T, 8*K8] . dequant(wp[M, K8], scales)^T in the fp32
// class, x fp32 (x_kind 0) or bf16 (1); same layouts as qt_planar_matmul.
extern "C" int qt_gemv_4bit(const void* wp, const void* scales,
                            int scale_kind, const void* table, const void* x,
                            int x_kind, void* y, int T, int M, int K8,
                            int has_factor, float factor, void* stream) {
  return static_cast<int>(
      x_kind == 1
          ? launch_planar<false, 2>(wp, scales, scale_kind, table, x, y, T, M,
                                    K8, has_factor, factor, stream)
          : launch_planar<false, 4>(wp, scales, scale_kind, table, x, y, T, M,
                                    K8, has_factor, factor, stream));
}

// ---------------------------------------------------------------------------
// K5's tensor-core body (qt_planar_mma): the function and rounding class of
// qt_planar_matmul, the same bf16 weights and activations, with the fp32
// sums in another order (the tensor cores', then the warps'). K5 launches
// it from PLANAR_MMA_MIN_TOKENS rows on (ops/qmatmul.py planar_body); the
// CUDA-core body above keeps the rows below.
//
// Bound: the weight bytes up to T = 64 (at T = 48 the 128 projections of
// a Llama3-8B forward are 0.72 TFLOP, 0.73 ms at 989 TFLOP/s, against
// 1.2 ms for their bytes at 3.35 TB/s). The CUDA-core body decodes every
// weight once per 16-token tile and spends one fp32 FMA per weight and
// token; this body decodes each weight once per 64 tokens and leaves the
// products to mma.sync.m16n8k16 (bf16 x bf16, fp32 sums):
//  - weights are the A operand (16 rows a tile), tokens the n8 tiles: all
//    of T <= 64 is one tile of NT <= 8 n8 tiles. Of the A fragment for a
//    16-column step s, lane (g, tg) holds rows g and g + 8 at columns 2tg,
//    2tg + 1 and 2tg + 8, 2tg + 9: byte tg of words 2s and 2s + 1 of each
//    row (a byte's high nibble is the even column). The lane decodes its
//    two codes with the fp32 table, multiplies each by the bf16 scale in
//    fp32 and packs them with one round-to-nearest bf16x2 conversion:
//    K5's rounding points;
//  - the B fragments come from the activation tile in its original column
//    order with ldmatrix.x4 (x [T, K] row-major is the .col B layout;
//    rows padded to 72 values: conflict-free), no permuted copy of x;
//  - split K: a block owns 16 * MT rows; each of its KS warps takes its
//    own range of whole 64-column scale blocks and streams them (words,
//    scales, activation rows) through its own cp.async ring of ST stages,
//    waiting with wait_group + __syncwarp: no block barrier in the loop;
//  - two-level sums, as in csrc/pair_prefill.cu: the mma accumulators of
//    one 64-column block start at zero and the block's partial is added
//    to the warp's running fp32 sum with an ordinary add (one chained
//    tensor-core accumulator over K = 14336 misses 1e-5 of max|y|);
//  - at the end each warp writes its partial into its own ring and, after
//    the block's only barrier, the warps' partials are added in warp
//    order: no atomics, reruns give the same bits.
// Any M, any T (tiles of 64 tokens on grid y above 64), K a multiple of
// 64; token and row tails are zero-filled and masked. mma.sync only: no
// wgmma, TMA or clusters.

namespace {

constexpr int kMmaLdx = 64 + 8;   // activation stage row, in bf16

template <int NT, int MT, int KS, int ST>
struct MmaTile {
  static constexpr int kRows = 16 * MT;             // weight rows a block
  static constexpr int kThreads = 32 * KS;
  static constexpr int kWords = 8 * kRows;          // uint32 a stage
  static constexpr int kX = 8 * NT * kMmaLdx;       // bf16 a stage
  static constexpr int kStage = 4 * kWords + 4 * kRows + 2 * kX;   // bytes
  static constexpr int kPartLd = kRows + 4;         // floats a partial row
  static constexpr size_t kSmem = (size_t)KS * ST * kStage;
  static_assert(8 * NT * kPartLd * 4 <= ST * kStage,
                "a warp's partial fits its ring");
};

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_m16n8k16(float* c, const uint32_t* a,
                                             const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The bf16 pair of byte `by` (already shifted down) of a word: the high
// nibble's weight (the even column) in the low half, each
// bf16_rn(table[code] * s) as K5 rounds it.
__device__ __forceinline__ uint32_t decode_pair(const float* tbl, uint32_t by,
                                                float s) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(
      __fmul_rn(tbl[(by >> 4) & 15u], s), __fmul_rn(tbl[by & 15u], s));
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int NT, int MT, int KS, int ST>
__global__ void __launch_bounds__(32 * KS)
planar_mma_kernel(const int32_t* __restrict__ wp,
                  const void* __restrict__ scales, int scale_kind,
                  const float* __restrict__ table,
                  const __nv_bfloat16* __restrict__ x, float* __restrict__ y,
                  int T, int M, int K8, int has_factor, float factor) {
  using TL = MmaTile<NT, MT, KS, ST>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float tbl[16];

  const int NB = K8 / 8;
  const int K = 8 * K8;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;       // mma fragment coordinates
  const int m0 = blockIdx.x * TL::kRows;
  const int t0 = blockIdx.y * 8 * NT;
  const int tv = min(T - t0, 8 * NT);           // the tile's tokens
  const int b0 = (int)((long long)warp * NB / KS);
  const int nblk = (int)((long long)(warp + 1) * NB / KS) - b0;
  const __nv_bfloat16 fac = __float2bfloat16_rn(factor);
  // bf16 scales come as the aligned 4-byte word holding them: which half
  const unsigned s_half0 =
      static_cast<unsigned>(reinterpret_cast<uintptr_t>(scales) >> 1);
  unsigned char* ring = smem + (size_t)warp * ST * TL::kStage;

  if (threadIdx.x < 16) tbl[threadIdx.x] = table[threadIdx.x];
  // activation rows past the tile's tokens are never copied: zero them
  // once in every stage
  for (int q = lane; q < ST * (8 * NT - tv) * 9; q += 32) {
    const int st = q / ((8 * NT - tv) * 9), r = q % ((8 * NT - tv) * 9);
    *reinterpret_cast<uint4*>(ring + st * TL::kStage + 4 * TL::kWords +
                              4 * TL::kRows +
                              2 * (tv + r / 9) * kMmaLdx + 16 * (r % 9)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // scale block b's copies into stage st, from sources fixed per lane:
  // the words of the block's rows (two 16-byte halves a row, MT a lane),
  // their scales (lanes below 16 MT; a bf16 scale as the aligned word that
  // holds it, an fp32 one is aligned already), the tile's activation rows
  // (8 lanes a token, 4 tokens a pass)
  const int32_t* wsrc[MT];
  bool wok[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const int r = (lane + 32 * j) >> 1, m = m0 + r;
    wok[j] = m < M;
    wsrc[j] = wp + (wok[j] ? (size_t)m * K8 + 4 * (lane & 1) : 0);
  }
  const int s_size = scale_kind == 0 ? 4 : 2;
  const bool sok = lane < TL::kRows && m0 + lane < M;
  const char* ssrc = static_cast<const char*>(scales) +
                     (sok ? (size_t)(m0 + lane) * NB * s_size : 0);
  const __nv_bfloat16* xsrc = x + (size_t)(t0 + (lane >> 3)) * K +
                              8 * (lane & 7);
  auto copy = [&](int b, int st) {
    unsigned char* base = ring + st * TL::kStage;
#pragma unroll
    for (int j = 0; j < MT; ++j)
      cp_async16(base + 16 * (lane + 32 * j), wsrc[j] + (wok[j] ? 8 * b : 0),
                 wok[j]);
    if (lane < TL::kRows)
      cp_async4(base + 4 * TL::kWords + 4 * lane,
                reinterpret_cast<const void*>(
                    reinterpret_cast<uintptr_t>(ssrc + (sok ? b * s_size : 0)) &
                    ~static_cast<uintptr_t>(3)),
                sok);
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(
        base + 4 * TL::kWords + 4 * TL::kRows);
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
      if (4 * j + (lane >> 3) < tv)
        cp_async16(xs + (4 * j + (lane >> 3)) * kMmaLdx + 8 * (lane & 7),
                   xsrc + (size_t)4 * j * K + 64 * b, true);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;

#pragma unroll
  for (int st = 0; st < ST - 1; ++st) {
    if (st < nblk) copy(b0 + st, st);
    cp_async_commit();
  }

  for (int i = 0; i < nblk; ++i) {
    cp_async_wait<ST - 2>();  // this lane's copies of step i landed
    __syncwarp();             // every lane's; and step i - 1's reads done
    if (i + ST - 1 < nblk) copy(b0 + i + ST - 1, (i + ST - 1) % ST);
    cp_async_commit();

    const int b = b0 + i;
    const unsigned char* base = ring + (i % ST) * TL::kStage;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(base);
    const uint32_t* sc = w + TL::kWords;
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(sc + TL::kRows);

    // the bf16 scale of rows g and g + 8 of each 16-row tile, in fp32
    float sv[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mt + g + 8 * h;
        const uint32_t u = sc[r];
        __nv_bfloat16 sb;
        if (scale_kind == 0) {
          sb = __float2bfloat16_rn(__uint_as_float(u));
        } else {
          const unsigned half =
              (s_half0 + (unsigned)(m0 + r) * (unsigned)NB + (unsigned)b) & 1u;
          __nv_bfloat16_raw raw;
          raw.x = static_cast<unsigned short>(u >> (16 * half));
          sb = __nv_bfloat16(raw);
        }
        if (has_factor) sb = __hmul(sb, fac);
        sv[mt][h] = __bfloat162float(sb);
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
        ldsm_x4(bf[n], xs + (8 * n + (lane & 7)) * kMmaLdx + 16 * s +
                           8 * (lane >> 3));
#pragma unroll
      for (int ss = 0; ss < 2; ++ss) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // words 2(s + ss) and 2(s + ss) + 1 of rows g and g + 8
          const uint2 lo = *reinterpret_cast<const uint2*>(
              w + 8 * (16 * mt + g) + 2 * (s + ss));
          const uint2 hi = *reinterpret_cast<const uint2*>(
              w + 8 * (16 * mt + g + 8) + 2 * (s + ss));
          const int sh = 8 * tg;
          const uint32_t a[4] = {decode_pair(tbl, lo.x >> sh, sv[mt][0]),
                                 decode_pair(tbl, hi.x >> sh, sv[mt][1]),
                                 decode_pair(tbl, lo.y >> sh, sv[mt][0]),
                                 decode_pair(tbl, hi.y >> sh, sv[mt][1])};
#pragma unroll
          for (int n = 0; n < NT; ++n)
            mma_m16n8k16(blk[mt][n], a, &bf[n][2 * ss]);
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
  // e] at row g + 8hh of the 16-row tile, token 2tg + e of the n8 tile
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        part[(8 * n + 2 * tg + (c & 1)) * TL::kPartLd + 16 * mt + g +
             8 * (c >> 1)] = acc[mt][n][c];
  __syncthreads();

  for (int q = threadIdx.x; q < tv * TL::kRows; q += TL::kThreads) {
    const int t = q / TL::kRows, r = q % TL::kRows;
    if (m0 + r >= M) continue;
    const float* p =
        reinterpret_cast<const float*>(smem) + t * TL::kPartLd + r;
    float v = p[0];
#pragma unroll
    for (int k = 1; k < KS; ++k)
      v += p[(size_t)k * ST * TL::kStage / 4];
    y[(size_t)(t0 + t) * M + m0 + r] = v;
  }
}

template <int NT, int MT, int KS, int ST>
cudaError_t launch_mma(const int32_t* wp, const void* scales, int scale_kind,
                       const float* table, const __nv_bfloat16* x, float* y,
                       int T, int M, int K8, int has_factor, float factor,
                       cudaStream_t stream) {
  using TL = MmaTile<NT, MT, KS, ST>;
  if (TL::kSmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        planar_mma_kernel<NT, MT, KS, ST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TL::kSmem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((M + TL::kRows - 1) / TL::kRows, (T + 8 * NT - 1) / (8 * NT));
  planar_mma_kernel<NT, MT, KS, ST><<<grid, TL::kThreads, TL::kSmem, stream>>>(
      wp, scales, scale_kind, table, x, y, T, M, K8, has_factor, factor);
  return cudaGetLastError();
}

// Up to 8 tokens, rows above this take 32-row blocks (the fused gate_up
// and the lm_head: 896 blocks and more), fewer take 16-row blocks (qkv,
// o, down: twice the blocks).
constexpr int kWideM = 16384;

}  // namespace

// K5 through its tensor-core body: the arguments and layouts of
// qt_planar_matmul. The block's shape (n8 tiles NT, 16-row tiles MT, K
// slices KS, ring stages ST) from T and M, as timed on an H100: up to 8
// tokens one n8 tile, 16 rows a block (32 above kWideM rows), 8 warps
// and 4 stages; 16 and 32 tokens 2 and 4 n8 tiles, 48 and 64 6 and 8, all
// with 32 rows; tiles of 64 tokens on grid y above. Returns
// cudaGetLastError() after the launch.
extern "C" int qt_planar_mma(const void* wp, const void* scales,
                             int scale_kind, const void* table, const void* x,
                             void* y, int T, int M, int K8, int has_factor,
                             float factor, void* stream) {
  auto w = static_cast<const int32_t*>(wp);
  auto tb = static_cast<const float*>(table);
  auto xx = static_cast<const __nv_bfloat16*>(x);
  auto yy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
#define QT_MMA(NT_, MT_, KS_, ST_)                                          \
  launch_mma<NT_, MT_, KS_, ST_>(w, scales, scale_kind, tb, xx, yy, T, M,  \
                                 K8, has_factor, factor, st)
  cudaError_t e;
  if (T <= 8)
    e = M > kWideM ? QT_MMA(1, 2, 8, 4) : QT_MMA(1, 1, 8, 4);
  else if (T <= 16)
    e = QT_MMA(2, 2, 8, 4);
  else if (T <= 32)
    e = QT_MMA(4, 2, 8, 2);
  else if (T <= 48)
    e = QT_MMA(6, 2, 8, 2);
  else
    e = QT_MMA(8, 2, 4, 2);
#undef QT_MMA
  return static_cast<int>(e);
}
