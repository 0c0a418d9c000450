// Blockwise 4-bit quantize (kernel K2) for sm_90a.
//
// Replaces quantizations_tpu/ops/quantize.py:93 _quantize_kernel
// (quantize_4bit_pallas :142). For each block of `blocksize` consecutive
// elements of a row-major W [M, K] (K a multiple of blocksize):
//   absmax = max |w|, NaN if the block holds a NaN
//   inv    = absmax > 0 ? 1.0f / absmax : 0
//   code   = FP4 ladder (bnb dQuantizeFP4, fp32 literal thresholds) or
//            the NF4 count of fp32 midpoints strictly below w * inv
// and 8 codes per int32 word in bnb byte order (element j at bit
// 8*(j/2) + 4 - 4*(j%2): high nibble = even element).
// Outputs wp int32 [M, K/8] and absmax fp32 [M, K/blocksize], bit-exact
// with ops/quantize.py quantize_4bit_kernel_plain on every input, NaN and
// inf included. Built without fast math: 1.0f / absmax must be the IEEE
// quotient (a subnormal absmax gives inv = inf, as in the plain version).
//
// Bound: bytes. It reads W once (4 or 2 bytes per element) and writes
// 1/8 of an fp32 W back. Each lane owns one output word: 8 consecutive
// elements in registers (two 16-byte loads for fp32, one for bf16), so a
// warp's loads cover 1 KB (fp32) or 512 B (bf16) of W without a gap and
// its store is 128 contiguous bytes. Where blocksize / 8 = L is a power
// of two up to 32 (blocksize 64: L = 8), L neighbouring lanes hold one
// quant block and take its absmax in log2(L) xor shuffles, so W is read
// once, and the encode runs from registers. A warp loads kSegs 32-word
// segments before its first reduction and walks W grid-stride, over a
// grid of SMs x resident blocks. Other blocksizes (not a power of two,
// or above 256): one warp a quant block, a max pass over its words, a
// shuffle reduction, then an encode pass that reads them again.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSegs = 2;       // 32-word segments a warp loads at once
constexpr unsigned kFull = 0xffffffffu;

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

// The larger of m and a, and NaN once either is NaN (fmaxf would drop
// it): torch.amax's result, which the plain version takes. a != a holds
// for a NaN only.
__device__ __forceinline__ float nan_max(float m, float a) {
  return (a > m || a != a) ? a : m;
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

__device__ __forceinline__ float absmax8(const float v[8]) {
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) m = nan_max(m, fabsf(v[j]));
  return m;
}

template <bool NF4>
__device__ __forceinline__ int32_t encode8(const float v[8], float inv,
                                           const float* mids) {
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float norm = v[j] * inv;
    const uint32_t code = NF4 ? nf4_code(norm, mids) : fp4_code(norm);
    word |= code << (8 * (j / 2) + 4 - 4 * (j % 2));
  }
  return static_cast<int32_t>(word);
}

template <bool NF4>
__device__ __forceinline__ void load_mids(const float* mids_in,
                                          float mids[15]) {
#pragma unroll
  for (int i = 0; i < 15; ++i) mids[i] = NF4 ? __ldg(mids_in + i) : 0.f;
}

// blocksize = 8 * L, L a power of two up to 32: L lanes a quant block.
template <typename TIn, int L, bool NF4>
__global__ void __launch_bounds__(kThreads)
quantize_group_kernel(const TIn* __restrict__ W,
                      const float* __restrict__ mids_in,
                      int32_t* __restrict__ wp, float* __restrict__ absmax,
                      long long nwords) {
  float mids[15];
  load_mids<NF4>(mids_in, mids);
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long stride = (long long)gridDim.x * kWarps * kSegs;
  const long long nseg = (nwords + 31) >> 5;
  // s is the same on every lane of a warp: the shuffles see all 32 lanes
  for (long long s = warp * kSegs; s < nseg; s += stride) {
    float v[kSegs][8];
#pragma unroll
    for (int u = 0; u < kSegs; ++u) {
      const long long c = (s + u) * 32 + lane;
      if (c < nwords) {
        load8(W + c * 8, v[u]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[u][j] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kSegs; ++u) {
      const long long c = (s + u) * 32 + lane;
      float m = absmax8(v[u]);
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1)
        m = nan_max(m, __shfl_xor_sync(kFull, m, o));
      const float inv = m > 0.f ? 1.0f / m : 0.f;
      // nwords is a multiple of L: a group is inside W or wholly past it
      if (c < nwords) {
        wp[c] = encode8<NF4>(v[u], inv, mids);
        if ((lane & (L - 1)) == 0) absmax[c / L] = m;
      }
    }
  }
}

// Any other blocksize (a multiple of 8): one warp a quant block of
// `words` words.
template <typename TIn, bool NF4>
__global__ void __launch_bounds__(kThreads)
quantize_block_kernel(const TIn* __restrict__ W,
                      const float* __restrict__ mids_in,
                      int32_t* __restrict__ wp, float* __restrict__ absmax,
                      long long nblocks, int words) {
  float mids[15];
  load_mids<NF4>(mids_in, mids);
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long b = warp; b < nblocks; b += nwarps) {
    const TIn* src = W + b * words * 8;
    float m = 0.f;
    for (int c = lane; c < words; c += 32) {
      float v[8];
      load8(src + 8 * c, v);
      m = nan_max(m, absmax8(v));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = nan_max(m, __shfl_xor_sync(kFull, m, o));
    if (lane == 0) absmax[b] = m;
    const float inv = m > 0.f ? 1.0f / m : 0.f;
    int32_t* dst = wp + b * words;
    for (int c = lane; c < words; c += 32) {
      float v[8];
      load8(src + 8 * c, v);
      dst[c] = encode8<NF4>(v, inv, mids);
    }
  }
}

// Blocks for `warps` warps of work, at most as many as the card holds
// at once (the kernels loop over the rest).
template <typename Kernel>
unsigned grid_for(Kernel kernel, long long warps) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const long long need = (warps + kWarps - 1) / kWarps;
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return static_cast<unsigned>(need < full ? need : full);
}

template <typename TIn, int L, bool NF4>
void launch_group(const TIn* W, const float* mids, int32_t* wp, float* am,
                  long long nwords, cudaStream_t st) {
  auto kernel = quantize_group_kernel<TIn, L, NF4>;
  const long long segs = (nwords + 31) / 32;
  kernel<<<grid_for(kernel, (segs + kSegs - 1) / kSegs), kThreads, 0, st>>>(
      W, mids, wp, am, nwords);
}

template <typename TIn, bool NF4>
void launch_typed(const void* Wv, const float* mids, int32_t* wp, float* am,
                  long long M, int K, int blocksize, cudaStream_t st) {
  const TIn* W = static_cast<const TIn*>(Wv);
  const long long nwords = M * (K / 8);
  switch (blocksize / 8) {
    case 1: return launch_group<TIn, 1, NF4>(W, mids, wp, am, nwords, st);
    case 2: return launch_group<TIn, 2, NF4>(W, mids, wp, am, nwords, st);
    case 4: return launch_group<TIn, 4, NF4>(W, mids, wp, am, nwords, st);
    case 8: return launch_group<TIn, 8, NF4>(W, mids, wp, am, nwords, st);
    case 16: return launch_group<TIn, 16, NF4>(W, mids, wp, am, nwords, st);
    case 32: return launch_group<TIn, 32, NF4>(W, mids, wp, am, nwords, st);
    default: {
      auto kernel = quantize_block_kernel<TIn, NF4>;
      const long long nblocks = M * (K / blocksize);
      kernel<<<grid_for(kernel, nblocks), kThreads, 0, st>>>(
          W, mids, wp, am, nblocks, blocksize / 8);
    }
  }
}

}  // namespace

// W [M, K] fp32 (w_is_bf16 = 0) or bf16 (1), contiguous and 16-byte
// aligned, M * K > 0; K a multiple of blocksize, blocksize a multiple of
// 8. quant_type 0 = FP4, 1 = NF4 (mids: the 15 fp32 NF4 midpoints).
// Returns cudaGetLastError() after the launch.
extern "C" int qt_quantize_4bit(const void* W, int w_is_bf16,
                                const void* mids, void* wp, void* absmax,
                                int M, int K, int blocksize, int quant_type,
                                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto md = static_cast<const float*>(mids);
  auto out = static_cast<int32_t*>(wp);
  auto am = static_cast<float*>(absmax);
  if (w_is_bf16 && quant_type)
    launch_typed<__nv_bfloat16, true>(W, md, out, am, M, K, blocksize, st);
  else if (w_is_bf16)
    launch_typed<__nv_bfloat16, false>(W, md, out, am, M, K, blocksize, st);
  else if (quant_type)
    launch_typed<float, true>(W, md, out, am, M, K, blocksize, st);
  else
    launch_typed<float, false>(W, md, out, am, M, K, blocksize, st);
  return static_cast<int>(cudaGetLastError());
}
