// GQA flash-decode attention over a KV cache (kernels K3 and K4) for sm_90a.
//
// K3 reads a bf16 cache and replaces, on the TPU,
//   quantizations_tpu/ops/attention.py:38 _kernel, reached through
//   flash_decode_attention (:171), flash_decode_attention_stacked (:224)
//   and ops/paged_attention.py:47 paged_flash_decode_attention.
// K4 reads int8 codes with a bf16 dequant step per cached row and replaces
//   quantizations_tpu/ops/attention.py:108 _kernel_i8, reached through
//   flash_decode_attention_stacked_i8 (:303) and
//   ops/paged_attention.py:141 paged_flash_decode_attention_i8.
//
// What both compute, for one (row b, kv head h) and each of the QG query
// rows r (row r is query position r / G and grouped head r % G, packed
// position-major), in fp32:
//   s[r, t] = (q[r] * scale) . k[t]            (K4: times kstep[t])
//   s       = softcap * tanh(s * (1 / softcap)) when softcap is set,
//             applied before the mask
//   visible  t < len[b] + r / G, and with a window
//             t > len[b] - 1 + r / G - win
//   out[r]  = sum_t p[r, t] v[t] / sum_t p[r, t],
//             p = exp(s - max) on visible t and 0 elsewhere
//             (K4: the numerator takes p[r, t] * vstep[t])
// The running max starts at the finite -1e30 of the TPU kernel, so a row
// with nothing visible gives l = 0 and writes acc = 0, never a NaN.
//
// Addressing. A cached row of position t lives at row index
//   (blk * KVH + h) * page + t % page   (times D for the K/V elements)
// with blk = table[b * max_pages + t / page] for the paged pool
// [P, KVH, page, D], or blk = b and page = S for the slot cache
// [B, KVH, S, D] (table is null). The stacked forms pass a pointer to
// layer li of [L, ...]: a pointer offset, nothing is copied.
//
// Bound: bytes. The work per cached position is 2 * QG * D FMAs against
// 2 * D * sizeof(elem) bytes read, far below the card's ratio of
// operations to bytes, so the least time is the K/V (and step) bytes of
// the visible positions over the memory rate. The design reads only the
// visible range [lo, hi) of each row, in 16-byte coalesced loads:
//  - one block of 8 warps per (b, h); the TPU's sequential S grid becomes
//    a loop inside the block: warp w takes the 32-position tiles
//    w, w + 8, ... of the range, each with its own online-softmax state;
//  - a warp stages its tile's K and V rows in shared memory (the K rows
//    padded by one word, so that lane j reading row j hits its own bank),
//    then lane j scores position j against every query row (the scaled q
//    sits in shared memory), and the warp folds the tile into its state:
//    max and sum by shuffles, then p broadcast by shuffles times the V
//    row, each lane owning D / 32 output dims;
//  - the 8 warp states are combined in shared memory at the end.
// With B * KVH blocks, a small batch occupies few SMs; splitting the
// sequence across blocks with a second combine pass is the redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                  // positions per warp tile
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Row index (in rows of D elements) of position t of (b, h).
__device__ __forceinline__ size_t row_index(int b, int h, int t,
                                            const int32_t* table,
                                            int max_pages, int page, int KVH) {
  int blk = b, off = t;
  if (table != nullptr) {
    blk = table[(size_t)b * max_pages + t / page];
    off = t - (t / page) * page;
  }
  return ((size_t)blk * KVH + h) * page + off;
}

template <typename T, int D>
__host__ __device__ constexpr int row_words() {
  return D * (int)sizeof(T) / 4;
}

// Shared memory: q [R][D] fp32, then per warp a K tile [32][words + 1]
// and a V tile [32][words]; the combine reuses the tiles' space.
template <typename T, int R, int D>
constexpr size_t smem_bytes() {
  constexpr size_t tiles =
      (size_t)kWarps * kTile * (2 * row_words<T, D>() + 1) * 4;
  constexpr size_t comb = (size_t)kWarps * R * (D + 2) * 4;
  return (size_t)R * D * 4 + (tiles > comb ? tiles : comb);
}

template <typename T, int R, int DV>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const void* __restrict__ q_, int q_f32,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const __nv_bfloat16* __restrict__ ks,
                    const __nv_bfloat16* __restrict__ vs,
                    const int32_t* __restrict__ table,
                    const int32_t* __restrict__ lengths,
                    float* __restrict__ out, int KVH, int QG, int G, int page,
                    int max_pages, int n_pos, int has_win, int win,
                    float scale, int has_cap, float cap, float inv_cap) {
  constexpr int D = 32 * DV;
  constexpr int kWords = row_words<T, D>();   // 32-bit words per row
  constexpr int kVec = kWords / 4;            // 16-byte vectors per row
  constexpr int kKStride = kWords + 1;
  constexpr bool kInt8 = sizeof(T) == 1;
  extern __shared__ float smem[];
  float* q_s = smem;                                         // [R][D]
  uint32_t* tiles = reinterpret_cast<uint32_t*>(smem + R * D);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint32_t* k_t = tiles + warp * kTile * (2 * kWords + 1);   // [32][kKStride]
  uint32_t* v_t = k_t + kTile * kKStride;                    // [32][kWords]

  const int bh = blockIdx.x;
  const int b = bh / KVH;
  const int h = bh - b * KVH;
  const int len = lengths[b];
  const int q_span = QG / G;
  const int hi = min(n_pos, len + q_span - 1);
  const int lo = has_win ? max(0, len - win) : 0;

  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    float x = 0.f;
    if (i < QG * D) {
      const size_t qi = (size_t)bh * QG * D + i;
      x = q_f32 ? static_cast<const float*>(q_)[qi]
                : __bfloat162float(
                      static_cast<const __nv_bfloat16*>(q_)[qi]);
    }
    q_s[i] = x * scale;
  }
  __syncthreads();

  float m[R], l[R], acc[R][DV];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < DV; ++d) acc[r][d] = 0.f;
  }

  for (int t0 = lo + warp * kTile; t0 < hi; t0 += kWarps * kTile) {
    // stage the tile's K and V rows (16-byte loads, zeros past hi)
    for (int idx = lane; idx < kTile * kVec; idx += 32) {
      const int j = idx / kVec;
      const int c = idx - j * kVec;
      const int t = t0 + j;
      uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
      if (t < hi) {
        const size_t row = row_index(b, h, t, table, max_pages, page, KVH);
        kw = __ldg(reinterpret_cast<const uint4*>(k + row * D) + c);
        vw = __ldg(reinterpret_cast<const uint4*>(v + row * D) + c);
      }
      uint32_t* kd = k_t + j * kKStride + 4 * c;
      kd[0] = kw.x;
      kd[1] = kw.y;
      kd[2] = kw.z;
      kd[3] = kw.w;
      reinterpret_cast<uint4*>(v_t + j * kWords)[c] = vw;
    }
    const int t = t0 + lane;
    const bool in = t < hi;
    float kstep = 1.f, vstep = 1.f;
    if (kInt8 && in) {
      const size_t row = row_index(b, h, t, table, max_pages, page, KVH);
      kstep = __bfloat162float(ks[row]);
      vstep = __bfloat162float(vs[row]);
    }
    __syncwarp();

    // scores of position t (this lane) against every query row
    float sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r] = 0.f;
    const T* krow = reinterpret_cast<const T*>(k_t + lane * kKStride);
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kv = to_float(krow[d]);
#pragma unroll
      for (int r = 0; r < R; ++r) sc[r] = fmaf(q_s[r * D + d], kv, sc[r]);
    }

    float pv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qpos = r / G;
      bool vis = in && r < QG && t < len + qpos;
      if (has_win) vis = vis && t > len - 1 + qpos - win;
      float s = sc[r];
      if (kInt8) s *= kstep;
      if (has_cap) s = cap * tanhf(s * inv_cap);
      s = vis ? s : kNeg;
      const float mn = fmaxf(m[r], warp_max(s));
      const float p = vis ? expf(s - mn) : 0.f;
      const float corr = expf(m[r] - mn);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = mn;
#pragma unroll
      for (int d = 0; d < DV; ++d) acc[r][d] *= corr;
      pv[r] = kInt8 ? p * vstep : p;
    }

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const T* vrow = reinterpret_cast<const T*>(v_t + j * kWords) + lane * DV;
      float vv[DV];
#pragma unroll
      for (int d = 0; d < DV; ++d) vv[d] = to_float(vrow[d]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = __shfl_sync(0xffffffffu, pv[r], j);
#pragma unroll
        for (int d = 0; d < DV; ++d) acc[r][d] = fmaf(pj, vv[d], acc[r][d]);
      }
    }
    __syncwarp();   // the next tile overwrites this one
  }

  // combine the warps' states
  __syncthreads();
  float* cm = reinterpret_cast<float*>(tiles);     // [kWarps][R]
  float* cl = cm + kWarps * R;                     // [kWarps][R]
  float* ca = cl + kWarps * R;                     // [kWarps][R][D]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      cm[warp * R + r] = m[r];
      cl[warp * R + r] = l[r];
    }
#pragma unroll
    for (int d = 0; d < DV; ++d)
      ca[(warp * R + r) * D + lane * DV + d] = acc[r][d];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < QG * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    float M = kNeg;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, cm[w * R + r]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(cm[w * R + r] - M);
      L = fmaf(f, cl[w * R + r], L);
      A = fmaf(f, ca[(w * R + r) * D + d], A);
    }
    out[(size_t)bh * QG * D + i] = L > 0.f ? A / L : A;
  }
}

template <typename T, int R, int DV>
cudaError_t launch(const void* q, int q_f32, const void* k, const void* v,
                   const void* ks, const void* vs, const void* table,
                   const void* lengths, void* out, int B, int KVH, int QG,
                   int G, int page, int max_pages, int n_pos, int has_win,
                   int win, float scale, int has_cap, float cap,
                   float inv_cap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, R, 32 * DV>();
  auto kern = flash_decode_kernel<T, R, DV>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<B * KVH, kThreads, smem, stream>>>(
      q, q_f32, static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs),
      static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lengths), static_cast<float*>(out), KVH,
      QG, G, page, max_pages, n_pos, has_win, win, scale, has_cap, cap,
      inv_cap);
  return cudaGetLastError();
}

template <typename T, int DV>
cudaError_t dispatch_rows(const void* q, int q_f32, const void* k,
                          const void* v, const void* ks, const void* vs,
                          const void* table, const void* lengths, void* out,
                          int B, int KVH, int QG, int G, int page,
                          int max_pages, int n_pos, int has_win, int win,
                          float scale, int has_cap, float cap, float inv_cap,
                          cudaStream_t st) {
#define QT_FD_LAUNCH(R)                                                     \
  return launch<T, R, DV>(q, q_f32, k, v, ks, vs, table, lengths, out, B, \
                          KVH, QG, G, page, max_pages, n_pos, has_win, win, \
                          scale, has_cap, cap, inv_cap, st)
  if (QG <= 4) QT_FD_LAUNCH(4);
  if (QG <= 8) QT_FD_LAUNCH(8);
  if (QG <= 16) QT_FD_LAUNCH(16);
  if (QG <= 32) QT_FD_LAUNCH(32);
#undef QT_FD_LAUNCH
  return cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const void* q, int q_f32, const void* k, const void* v,
             const void* ks, const void* vs, const void* table,
             const void* lengths, void* out, int B, int KVH, int QG, int G,
             int D, int page, int max_pages, int n_pos, int has_win, int win,
             float scale, int has_cap, float cap, float inv_cap,
             void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (B * KVH > 0 && QG > 0 && G > 0 && QG % G == 0) {
    if (D == 64)
      e = dispatch_rows<T, 2>(q, q_f32, k, v, ks, vs, table, lengths, out, B,
                              KVH, QG, G, page, max_pages, n_pos, has_win, win,
                              scale, has_cap, cap, inv_cap, st);
    else if (D == 128)
      e = dispatch_rows<T, 4>(q, q_f32, k, v, ks, vs, table, lengths, out, B,
                              KVH, QG, G, page, max_pages, n_pos, has_win, win,
                              scale, has_cap, cap, inv_cap, st);
  }
  return static_cast<int>(e);
}

}  // namespace

// out[B, KVH, QG, D] fp32 from q[B, KVH, QG, D] (bf16, or fp32 when q_f32)
// and a bf16 cache: the slot cache [B, KVH, page = S, D] when table is
// null, else the pool [P, KVH, page, D] through table[B, max_pages].
// Positions t < n_pos are attended (attend_len, or max_pages * page).
// D is 64 or 128, QG <= 32. Returns cudaGetLastError() after the launch.
extern "C" int qt_flash_decode_bf16(const void* q, int q_f32, const void* k,
                                    const void* v, const void* table,
                                    const void* lengths, void* out, int B,
                                    int KVH, int QG, int G, int D, int page,
                                    int max_pages, int n_pos, int has_win,
                                    int win, float scale, int has_cap,
                                    float cap, float inv_cap, void* stream) {
  return dispatch<__nv_bfloat16>(q, q_f32, k, v, nullptr, nullptr, table,
                                 lengths, out, B, KVH, QG, G, D, page,
                                 max_pages, n_pos, has_win, win, scale,
                                 has_cap, cap, inv_cap, stream);
}

// The same over int8 codes with bf16 steps ks/vs laid out as the codes
// without D ([B, KVH, S] or [P, KVH, page]).
extern "C" int qt_flash_decode_i8(const void* q, int q_f32, const void* k,
                                  const void* v, const void* ks,
                                  const void* vs, const void* table,
                                  const void* lengths, void* out, int B,
                                  int KVH, int QG, int G, int D, int page,
                                  int max_pages, int n_pos, int has_win,
                                  int win, float scale, int has_cap,
                                  float cap, float inv_cap, void* stream) {
  return dispatch<int8_t>(q, q_f32, k, v, ks, vs, table, lengths, out, B, KVH,
                          QG, G, D, page, max_pages, n_pos, has_win, win,
                          scale, has_cap, cap, inv_cap, stream);
}
