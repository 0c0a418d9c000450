// The decoder layer's elementwise glue for sm_90a: K11 residual add +
// RMSNorm, K12 rope on q and k, K13 the gated MLP's activation.
//
// They replace no Pallas site: the JAX package leaves this glue to XLA,
// which fuses it (quantizations_tpu/models/llama.py:616 rms_norm, :623
// _norm, :666 apply_rope, :632 _act, the residual adds at :1039 and
// :1058). Eagerly, the port ran it as ~35 torch kernels a layer, each a
// launch the host has to enqueue; these three take their place, with
// the plain PyTorch versions' values:
//
//   K11: res = X(x + X(delta))          (X: x's type; no add without delta)
//        y   = Y((xf * rsqrt(mean(xf * xf) + eps)) * wf),  xf = float(res)
//        wf  = float(w), + 1 with plus_one (Gemma's 1 + w)
//   K12: out[j]     = x[j] * cos[j] + (-x[j + D/2]) * sin[j]
//        out[j+D/2] = x[j+D/2] * cos[j+D/2] + x[j] * sin[j+D/2]   (j < D/2)
//        over the q heads and the k heads of each row, fp32
//   K13: out = Y(act(g) * u), act silu x / (1 + exp(-x)) or tanh-gelu
//
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn: no
// contraction into an FMA), in the plain version's order, so the
// residual, rope and activation outputs are the plain version's bits on
// the card. The norm's sum of squares runs in another order than torch's
// reduction, so y may differ from the plain version's by 1 ulp of Y.
// The activations follow PyTorch's CUDA kernels expression for
// expression (ActivationSiluKernel.cu, ActivationGeluKernel.cu).
//
// Bound: bytes; none of the three does more than a few operations a byte.
// At a 256-row Mistral-7B decode step K11 moves 2 MB (bf16 residual in
// and out, fp32 delta, bf16 y), K12 5 MB, K13 29 MB: 0.6, 1.5 and 8.8 us
// at 3.35 TB/s. What they save is the launches and the fp32 temporaries
// between them. K11 runs one block a row: each thread reads its strided
// columns twice (the second pass from L1/L2), a warp-shuffle sum of
// squares between the passes. K12 and K13 run one thread an output pair
// or element, consecutive threads on consecutive columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNormThreads = 256;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

// kind: 0 = fp32, 1 = bf16
__device__ __forceinline__ float load(const void* p, int kind, size_t i) {
  return kind == 0 ? static_cast<const float*>(p)[i]
                   : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ float round_to(float v, int kind) {
  return kind == 0 ? v : __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(void* p, int kind, size_t i, float v) {
  if (kind == 0) {
    static_cast<float*>(p)[i] = v;
  } else {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  }
}

// The residual at (row, c): x, or X(x + X(delta)) with a delta
// (delta_kind 1 = fp32, 2 = bf16).
__device__ __forceinline__ float residual(const void* x, int x_kind,
                                          size_t xi, const void* delta,
                                          int delta_kind, size_t di) {
  const float xv = load(x, x_kind, xi);
  if (delta_kind == 0) return xv;
  const float d = round_to(load(delta, delta_kind - 1, di), x_kind);
  return round_to(__fadd_rn(xv, d), x_kind);
}

__global__ void __launch_bounds__(kNormThreads)
add_rms_norm_kernel(const void* x, int x_kind, int64_t ldx,
                    const void* delta, int delta_kind, int64_t ldd,
                    const void* w, int w_kind, int plus_one, void* res,
                    void* y, int y_kind, int H, float eps, float inv_h) {
  const int64_t row = blockIdx.x;
  const size_t xr = static_cast<size_t>(row * ldx);
  const size_t dr = static_cast<size_t>(row * ldd);
  const size_t orow = static_cast<size_t>(row) * H;
  float ss = 0.0f;
  for (int c = threadIdx.x; c < H; c += kNormThreads) {
    const float v = residual(x, x_kind, xr + c, delta, delta_kind, dr + c);
    if (delta_kind != 0) store(res, x_kind, orow + c, v);
    ss = __fadd_rn(ss, __fmul_rn(v, v));
  }
  __shared__ float warp_sums[kNormThreads / 32];
  __shared__ float total;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < kNormThreads / 32; ++i) t = __fadd_rn(t, warp_sums[i]);
    total = t;
  }
  __syncthreads();
  const float r = rsqrtf(__fadd_rn(__fmul_rn(total, inv_h), eps));
  for (int c = threadIdx.x; c < H; c += kNormThreads) {
    const float v = residual(x, x_kind, xr + c, delta, delta_kind, dr + c);
    float wf = load(w, w_kind, c);
    if (plus_one) wf = __fadd_rn(wf, 1.0f);
    store(y, y_kind, orow + c, __fmul_rn(__fmul_rn(v, r), wf));
  }
}

__global__ void __launch_bounds__(kThreads)
rope_qk_kernel(const float* q, int64_t ldq, const float* k, int64_t ldk,
               const float* cos_t, const float* sin_t, float* q_out,
               float* k_out, int64_t N, int n_q, int n_kv, int D) {
  const int half = D / 2;
  const int64_t per_row = static_cast<int64_t>(n_q + n_kv) * half;
  const int64_t total = N * per_row;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = i / per_row;
    const int rem = static_cast<int>(i - row * per_row);
    const int head = rem / half;
    const int j = rem - head * half;
    const float* src;
    float* dst;
    if (head < n_q) {
      src = q + row * ldq + static_cast<int64_t>(head) * D;
      dst = q_out + (row * n_q + head) * D;
    } else {
      src = k + row * ldk + static_cast<int64_t>(head - n_q) * D;
      dst = k_out + (row * n_kv + head - n_q) * D;
    }
    const float* c = cos_t + row * D;
    const float* s = sin_t + row * D;
    const float a = src[j];
    const float b = src[j + half];
    dst[j] = __fadd_rn(__fmul_rn(a, c[j]), __fmul_rn(-b, s[j]));
    dst[j + half] = __fadd_rn(__fmul_rn(b, c[j + half]),
                              __fmul_rn(a, s[j + half]));
  }
}

// act: 0 = silu, 1 = tanh-gelu
__device__ __forceinline__ float activation(float x, int act) {
  if (act == 0) return x / (1.0f + expf(-x));
  // PyTorch's GeluCUDAKernelImpl (approximate "tanh"), as written there
  constexpr float kBeta = 1.41421356237309504880 * 1.12837916709551257390 *
                          static_cast<float>(0.5);
  constexpr float kKappa = 0.044715;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.0f + tanhf(inner));
}

__global__ void __launch_bounds__(kThreads)
glu_act_kernel(const float* g, int64_t ldg, const float* u, int64_t ldu,
               void* out, int out_kind, int64_t N, int I, int act) {
  const int64_t total = N * I;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = i / I;
    const int64_t c = i - row * I;
    const float a = activation(g[row * ldg + c], act);
    store(out, out_kind, static_cast<size_t>(i),
          __fmul_rn(a, u[row * ldu + c]));
  }
}

int grid_for(int64_t total) {
  const int64_t want = (total + kThreads - 1) / kThreads;
  return static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
}

}  // namespace

// K11 over N rows of H: x (row stride ldx) and an optional delta (row
// stride ldd) in, the residual res (only with a delta) and y out, both
// [N, H] contiguous. Returns cudaGetLastError() after the launch.
extern "C" int qt_add_rms_norm(const void* x, int x_kind, int64_t ldx,
                               const void* delta, int delta_kind,
                               int64_t ldd, const void* w, int w_kind,
                               int plus_one, void* res, void* y, int y_kind,
                               int N, int H, float eps, float inv_h,
                               void* stream) {
  add_rms_norm_kernel<<<N, kNormThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, x_kind, ldx, delta, delta_kind, ldd, w, w_kind, plus_one, res, y,
      y_kind, H, eps, inv_h);
  return static_cast<int>(cudaGetLastError());
}

// K12 over N rows: q [N, n_q*D] (row stride ldq) and k [N, n_kv*D] (row
// stride ldk) rotated with cos/sin [N, D] into q_out, k_out (contiguous).
extern "C" int qt_rope_qk(const void* q, int64_t ldq, const void* k,
                          int64_t ldk, const void* cos_t, const void* sin_t,
                          void* q_out, void* k_out, int64_t N, int n_q,
                          int n_kv, int D, void* stream) {
  const int64_t total = N * (n_q + n_kv) * (D / 2);
  rope_qk_kernel<<<grid_for(total), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), ldq, static_cast<const float*>(k), ldk,
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<float*>(q_out), static_cast<float*>(k_out), N, n_q, n_kv,
      D);
  return static_cast<int>(cudaGetLastError());
}

// K13 over N rows of I: g (row stride ldg) and u (row stride ldu), fp32,
// into out [N, I] contiguous.
extern "C" int qt_glu_act(const void* g, int64_t ldg, const void* u,
                          int64_t ldu, void* out, int out_kind, int64_t N,
                          int I, int act, void* stream) {
  glu_act_kernel<<<grid_for(N * I), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), ldg, static_cast<const float*>(u), ldu,
      out, out_kind, N, I, act);
  return static_cast<int>(cudaGetLastError());
}
