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
// Bound: bytes. The work per cached position is 2 * QG * D fp32 FMAs
// against 2 * D * sizeof(elem) bytes read, far below the card's ratio of
// operations to bytes, so the least time is the K/V (and step) bytes of
// the visible positions over the memory rate. The design (flash-decoding):
//  - the grid is (B * KVH, n_split, row groups). The TPU's sequential S
//    grid axis becomes n_split blocks, each taking a chunk of `chunk`
//    positions of [0, n_pos), so that a small batch still fills the SMs;
//    the wrapper picks n_split and chunk from what the host knows
//    (ops/attention.py decode_split). Query rows come in groups of at
//    most 8 (a grid axis), so that no block holds the sums of 32 rows:
//    each group re-reads K/V, mostly from L2;
//  - inside a block, 4 or 8 warps (kWarps) take the chunk's 16-position
//    tiles in turn.
//    A warp stages its tiles' K and V rows (and K4's step words) with
//    16-byte cp.async into a ring of two stages of its own, zero-filled
//    past the end, and copies tile i + 1 while it computes tile i; it
//    waits on its own copies only (cp.async.wait_group + __syncwarp), no
//    block barrier in the loop. The 16-byte chunks of a staged row are
//    XOR-swizzled by position, so that 8 lanes reading 8 rows' chunk c
//    hit 8 bank groups;
//  - scores: two lanes per position, each taking half of D against the
//    scaled q in shared memory (read as float4 broadcasts), added by one
//    shuffle; the tile's max by shuffles within 16 lanes (each lane keeps
//    the sum of its own positions, added up once at the end); p goes to
//    shared memory, and each lane owns D / 32 output dims of
//    sum_t p v[t] (reading p four positions at a time);
//  - the block folds its warps' states in shared memory and writes out
//    directly when n_split == 1, else its partial (max, sum, acc) in fp32
//    to scratch; a split that sees nothing writes sum 0 and exits. A
//    second launch from the same entry point folds the splits in order,
//    with no atomics: two launches on the same inputs are bit-identical.
//    It is a programmatic dependent launch: it starts while the split
//    grid drains and waits (griddepcontrol.wait) for its writes.
// Its times, per launch against the bound and PyTorch's SDPA, and the
// sweeps of splits and warp counts behind the constants are in PERF.md.
// The math stays fp32 on the CUDA cores (~125 MFLOP at B = 4, 1900
// positions, ~2 us at 67 TFLOP/s): bf16 or tf32 products would miss the
// 1e-5 * max|out| agreement with the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The block's shape: a warp tile of 16 positions, two cp.async stages per
// warp, and 4 warps, or 8 for K4 at up to 4 rows a group: its tiles are
// half K3's bytes, and 8 warps keep as many in flight (8 spill at 8 rows
// and lose there, and K3 gains nothing from them; PERF.md, PR 7).
template <typename T, int R>
constexpr int kWarps = sizeof(T) == 1 && R <= 4 ? 8 : 4;
constexpr int kTile = 16;
constexpr int kStages = 2;
constexpr int kMaxRows = 8;      // query rows per block (one row group)
constexpr int kMaxSplits = 1024;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const __nv_bfloat16* ks;
  const __nv_bfloat16* vs;
  const int32_t* table;
  const int32_t* lengths;
  float* out;
  float* part;       // [n_split][B * KVH * QG][D] when n_split > 1
  float* part_ml;    // [n_split][B * KVH * QG][2]: max, sum
  int q_f32, KVH, QG, G, page, max_pages, n_pos, has_win, win;
  float scale;
  int has_cap;
  float cap, inv_cap;
  int n_split, chunk, group_rows;
};

// Sizes of one staged row of D elements of T.
template <typename T, int D>
struct Row {
  static constexpr int kBytes = D * (int)sizeof(T);
  static constexpr int kChunks = kBytes / 16;      // 16-byte chunks
  static constexpr int kHalf = kChunks / 2;        // chunks a lane scores
  static constexpr int kElems = 16 / (int)sizeof(T);
  static constexpr int kSwz = kChunks < 8 ? kChunks : 8;
  static constexpr int kDV = D / 32;               // output dims per lane
  static constexpr int kLaneBytes = kDV * (int)sizeof(T);
  static constexpr int kTileBytes = kTile * kBytes;
  // a stage: K tile, V tile, then (K4) 16 k-step words, 16 v-step words
  // and the 16 positions' row indices
  static constexpr int kStageBytes =
      2 * kTileBytes + (sizeof(T) == 1 ? 3 * kTile * 4 : 0);
};

// Shared memory: q [R][D] fp32, p [kWarps][R][kTile] fp32, then the
// warps' rings; the final fold of the warps reuses the rings' space.
template <typename T, int R, int D>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr size_t warps = kWarps<T, R>;
  constexpr size_t ring = warps * kStages * Row<T, D>::kStageBytes;
  constexpr size_t fold = warps * R * (D + 2) * 4;
  return (size_t)R * D * 4 + warps * R * kTile * 4 +
         (ring > fold ? ring : fold);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is not read).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// max and sum over the 16 lanes of a half warp
__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The elements of a 32-bit word of T, in order, as fp32.
template <typename T>
__device__ __forceinline__ void unpack_word(uint32_t w, float* f) {
  if constexpr (sizeof(T) == 2) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = static_cast<float>(static_cast<int8_t>(w >> (8 * i)));
  }
}

// The kLaneBytes bytes of a lane's output dims, as fp32.
template <typename T, int D>
__device__ __forceinline__ void load_lane(const unsigned char* src,
                                          float* f) {
  using RW = Row<T, D>;
  if constexpr (RW::kLaneBytes == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(src);
    unpack_word<T>(w.x, f);
    unpack_word<T>(w.y, f + 4 / sizeof(T));
  } else if constexpr (RW::kLaneBytes == 4) {
    unpack_word<T>(*reinterpret_cast<const uint32_t*>(src), f);
  } else {   // two int8 codes
    const uint32_t w = *reinterpret_cast<const uint16_t*>(src);
    f[0] = static_cast<float>(static_cast<int8_t>(w));
    f[1] = static_cast<float>(static_cast<int8_t>(w >> 8));
  }
}

// A bf16 step of row `row`: its 4-byte word (copied by cp4) and the half.
__device__ __forceinline__ const void* step_word(const __nv_bfloat16* s,
                                                 uint32_t row) {
  return reinterpret_cast<const void*>(
      reinterpret_cast<uintptr_t>(s + row) & ~static_cast<uintptr_t>(3));
}

__device__ __forceinline__ float step_of(uint32_t word,
                                         const __nv_bfloat16* s,
                                         uint32_t row) {
  const bool high = (reinterpret_cast<uintptr_t>(s + row) >> 1) & 1;
  return __uint_as_float(high ? (word & 0xffff0000u) : (word << 16));
}

// Copy the warp tile of positions [t0, t0 + kTile) (zeros from `end` on)
// into the ring stage `st`. Lane j finds the row of position j once (the
// table read for the pool); the copies take it by shuffle.
template <typename T, int D>
__device__ __forceinline__ void issue_tile(const Params& p, unsigned char* st,
                                           int t0, int end, int b, int h,
                                           int lane) {
  using RW = Row<T, D>;
  const int t = t0 + (lane & (kTile - 1));
  const bool ok = t < end;
  uint32_t row = 0;
  if (ok) {
    int blk = b, off = t;
    if (p.table != nullptr) {
      const int pg = t / p.page;
      blk = p.table[(size_t)b * p.max_pages + pg];
      off = t - pg * p.page;
    }
    row = ((uint32_t)blk * p.KVH + h) * p.page + off;
  }
#pragma unroll
  for (int i = 0; i < kTile * RW::kChunks / 32; ++i) {
    const int idx = lane + 32 * i;
    const int j = idx / RW::kChunks;
    const int c = idx - j * RW::kChunks;
    const uint32_t rj = __shfl_sync(kFull, row, j);
    const bool okj = t0 + j < end;
    const size_t src = (size_t)rj * RW::kBytes + c * 16;
    const int dst = (j * RW::kChunks + (c ^ (j & (RW::kSwz - 1)))) * 16;
    cp16(st + dst, static_cast<const unsigned char*>(p.k) + src, okj);
    cp16(st + RW::kTileBytes + dst,
         static_cast<const unsigned char*>(p.v) + src, okj);
  }
  if constexpr (sizeof(T) == 1) {
    if (lane < kTile) {
      uint32_t* w = reinterpret_cast<uint32_t*>(st + 2 * RW::kTileBytes);
      cp4(w + lane, step_word(p.ks, row), ok);
      cp4(w + kTile + lane, step_word(p.vs, row), ok);
      w[2 * kTile + lane] = row;
    }
  }
}

// Two blocks an SM, as the split rule's grid assumes; the bound also
// keeps ptxas from capping K4's 8-warp body at 80 registers with spills.
template <typename T, int R, int D>
__global__ void __launch_bounds__((kWarps<T, R> * 32), 2)
flash_decode_split(const __grid_constant__ Params p) {
  using RW = Row<T, D>;
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr int kW = kWarps<T, R>;
  constexpr int kDV = RW::kDV;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                 // [R][D]
  float* p_all = q_s + R * D;                           // [kW][R][kTile]
  unsigned char* rings = reinterpret_cast<unsigned char*>(
      p_all + kW * R * kTile);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int b = bh / p.KVH;
  const int h = bh - b * p.KVH;
  const int row0 = blockIdx.z * p.group_rows;
  const int nrows = min(p.group_rows, p.QG - row0);
  const size_t orow = (size_t)bh * p.QG + row0;         // first output row
  const int len = p.lengths[b];
  // the positions any row of the group may see, cut to this split
  const int qlo = row0 / p.G;
  const int qhi = (row0 + nrows - 1) / p.G;
  const int lo = p.has_win ? max(0, len + qlo - p.win) : 0;
  const int hi = min(p.n_pos, len + qhi);
  const int start = max(lo, split * p.chunk);
  const int end = min(hi, (split + 1) * p.chunk);
  const size_t prow = (size_t)split * gridDim.x * p.QG + orow;

  if (start >= end && p.n_split > 1) {   // nothing visible: sum 0
    if (threadIdx.x < nrows) {
      p.part_ml[2 * (prow + threadIdx.x)] = kNeg;
      p.part_ml[2 * (prow + threadIdx.x) + 1] = 0.f;
    }
    return;
  }

  unsigned char* ring = rings + (size_t)warp * kStages * RW::kStageBytes;
  float* p_s = p_all + warp * R * kTile;                       // [R][kTile]
  const int n_tiles = end > start ? (end - start + kTile - 1) / kTile : 0;
  const int mine = n_tiles > warp ? (n_tiles - warp + kW - 1) / kW : 0;
  const int pos = lane & 15;     // this lane's position in a tile
  const int half = lane >> 4;    // and its half of D when scoring

  // Issue the first tiles before staging q, so that their loads overlap it.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < mine)
      issue_tile<T, D>(p, ring + s * RW::kStageBytes,
                       start + (warp + s * kW) * kTile, end, b, h, lane);
    cp_commit();
  }
  for (int i = threadIdx.x; i < R * D; i += kW * 32) {
    float x = 0.f;
    if (i < nrows * D) {
      const size_t qi = orow * D + i;
      x = p.q_f32 ? static_cast<const float*>(p.q)[qi]
                  : __bfloat162float(
                        static_cast<const __nv_bfloat16*>(p.q)[qi]);
    }
    q_s[i] = x * p.scale;
  }
  __syncthreads();

  // row r sees wlo[r] < t < lim[r]
  int lim[R], wlo[R];
  float m[R], l[R], acc[R][kDV];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qpos = (row0 + r) / p.G;
    lim[r] = r < nrows ? len + qpos : 0;
    wlo[r] = p.has_win ? len - 1 + qpos - p.win : -1;
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < kDV; ++d) acc[r][d] = 0.f;
  }

  for (int it = 0; it < mine; ++it) {
    const int ahead = it + kStages - 1;
    if (ahead < mine)
      issue_tile<T, D>(p, ring + (ahead % kStages) * RW::kStageBytes,
                       start + (warp + ahead * kW) * kTile, end, b, h, lane);
    cp_commit();
    cp_wait<kStages - 1>();
    __syncwarp();

    const unsigned char* st = ring + (it % kStages) * RW::kStageBytes;
    const int t = start + (warp + it * kW) * kTile + pos;

    // the score of position pos against every row: half of D on each lane
    float sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r] = 0.f;
    const uint4* kt = reinterpret_cast<const uint4*>(st);
#pragma unroll
    for (int cc = 0; cc < RW::kHalf; ++cc) {
      const int c = half * RW::kHalf + cc;
      constexpr int kPer = RW::kElems / 4;
      float kf[RW::kElems];
      const uint4 w = kt[pos * RW::kChunks + (c ^ (pos & (RW::kSwz - 1)))];
      unpack_word<T>(w.x, kf);
      unpack_word<T>(w.y, kf + kPer);
      unpack_word<T>(w.z, kf + 2 * kPer);
      unpack_word<T>(w.w, kf + 3 * kPer);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4* qv =
            reinterpret_cast<const float4*>(q_s + r * D + c * RW::kElems);
#pragma unroll
        for (int e = 0; e < RW::kElems / 4; ++e) {
          const float4 qq = qv[e];
          sc[r] = fmaf(qq.x, kf[4 * e], sc[r]);
          sc[r] = fmaf(qq.y, kf[4 * e + 1], sc[r]);
          sc[r] = fmaf(qq.z, kf[4 * e + 2], sc[r]);
          sc[r] = fmaf(qq.w, kf[4 * e + 3], sc[r]);
        }
      }
    }
    float kstep = 1.f, vstep = 1.f;
    if constexpr (kInt8) {
      const uint32_t* w =
          reinterpret_cast<const uint32_t*>(st + 2 * RW::kTileBytes);
      const uint32_t row = w[2 * kTile + pos];
      kstep = step_of(w[pos], p.ks, row);
      vstep = step_of(w[kTile + pos], p.vs, row);
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool vis = t < end && t < lim[r] && t > wlo[r];
      float s = sc[r] + __shfl_xor_sync(kFull, sc[r], 16);
      if (kInt8) s *= kstep;
      if (p.has_cap) s = p.cap * tanhf(s * p.inv_cap);
      s = vis ? s : kNeg;
      const float mn = fmaxf(m[r], max16(s));
      const float pr = vis ? expf(s - mn) : 0.f;
      if (half == 0) p_s[r * kTile + pos] = kInt8 ? pr * vstep : pr;
      const float corr = expf(m[r] - mn);
      l[r] = l[r] * corr + pr;   // this lane's positions; summed at the end
      m[r] = mn;
#pragma unroll
      for (int d = 0; d < kDV; ++d) acc[r][d] *= corr;
    }
    __syncwarp();

    // acc[r][lane's dims] += sum_j p[r][j] v[j]
    const unsigned char* vt = st + RW::kTileBytes;
    const int lb = lane * RW::kLaneBytes;
#pragma unroll
    for (int j4 = 0; j4 < kTile; j4 += 4) {
      float vv[4][kDV];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j4 + jj;
        load_lane<T, D>(vt + j * RW::kBytes +
                            (((lb >> 4) ^ (j & (RW::kSwz - 1))) << 4) +
                            (lb & 15),
                        vv[jj]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 pj =
            *reinterpret_cast<const float4*>(p_s + r * kTile + j4);
#pragma unroll
        for (int d = 0; d < kDV; ++d) {
          acc[r][d] = fmaf(pj.x, vv[0][d], acc[r][d]);
          acc[r][d] = fmaf(pj.y, vv[1][d], acc[r][d]);
          acc[r][d] = fmaf(pj.z, vv[2][d], acc[r][d]);
          acc[r][d] = fmaf(pj.w, vv[3][d], acc[r][d]);
        }
      }
    }
    __syncwarp();   // the next issue overwrites this stage and p
  }

  // let the combine launch (it waits for this grid to finish), then fold
  // the lanes' sums and the warps' states
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#pragma unroll
  for (int r = 0; r < R; ++r) l[r] = sum16(l[r]);
  __syncthreads();
  float* cm = reinterpret_cast<float*>(rings);     // [kW][R]
  float* cl = cm + kW * R;                         // [kW][R]
  float* ca = cl + kW * R;                         // [kW][R][D]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      cm[warp * R + r] = m[r];
      cl[warp * R + r] = l[r];
    }
#pragma unroll
    for (int d = 0; d < kDV; ++d)
      ca[(warp * R + r) * D + lane * kDV + d] = acc[r][d];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * D; i += kW * 32) {
    const int r = i / D;
    const int d = i - r * D;
    float M = kNeg;
    for (int w = 0; w < kW; ++w) M = fmaxf(M, cm[w * R + r]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kW; ++w) {
      const float f = expf(cm[w * R + r] - M);
      L = fmaf(f, cl[w * R + r], L);
      A = fmaf(f, ca[(w * R + r) * D + d], A);
    }
    if (p.n_split == 1) {
      p.out[(orow + r) * D + d] = L > 0.f ? A / L : A;
    } else {
      p.part[(prow + r) * D + d] = A;
      if (d == 0) {
        p.part_ml[2 * (prow + r)] = M;
        p.part_ml[2 * (prow + r) + 1] = L;
      }
    }
  }
}

// Fold the n_split partials of each output row in split order: one block
// of D threads per row of out [rows][D]. The splits' (max, sum) are read
// at once into shared memory, their weights computed once, then every
// thread sums its dim over the splits with independent loads.
__global__ void flash_decode_combine(const float* __restrict__ part,
                                     const float* __restrict__ part_ml,
                                     float* __restrict__ out, int rows,
                                     int n_split, int D) {
  extern __shared__ float sm[];
  float* sm_m = sm;                 // [n_split]
  float* sm_l = sm + n_split;       // [n_split]
  float* sm_w = sm + 2 * n_split;   // [n_split]: 0 where the sum is 0
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  // launched early (programmatic dependent launch): wait until the split
  // grid has finished and its writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int s = d; s < n_split; s += blockDim.x) {
    const size_t pr = (size_t)s * rows + row;
    sm_m[s] = part_ml[2 * pr];
    sm_l[s] = part_ml[2 * pr + 1];
  }
  __syncthreads();
  float M = kNeg;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, sm_m[s]);
  for (int s = d; s < n_split; s += blockDim.x)
    sm_w[s] = sm_l[s] > 0.f ? expf(sm_m[s] - M) : 0.f;
  __syncthreads();
  float L = 0.f, A = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) {
    const float a = part[((size_t)s * rows + row) * D + d];
    const float w = sm_w[s];
    L = fmaf(w, sm_l[s], L);
    A = fmaf(w, sm_l[s] > 0.f ? a : 0.f, A);   // sum 0: no acc written
  }
  out[row * D + d] = L > 0.f ? A / L : A;
}

template <typename T, int R, int D>
cudaError_t launch(const Params& p, int BKVH, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, R, D>();
  auto kern = flash_decode_split<T, R, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(BKVH, p.n_split,
                  (p.QG + p.group_rows - 1) / p.group_rows);
  constexpr int threads = kWarps<T, R> * 32;
  kern<<<grid, threads, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.n_split == 1) return e;
  // the combine may start while the split grid drains
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BKVH * p.QG);
  cfg.blockDim = dim3(D);
  cfg.dynamicSmemBytes = 3 * p.n_split * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, flash_decode_combine,
                         static_cast<const float*>(p.part),
                         static_cast<const float*>(p.part_ml), p.out,
                         BKVH * p.QG, p.n_split, D);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int dispatch(Params p, int B, int D, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const long long bkvh = (long long)B * p.KVH;
  const bool ok =
      bkvh > 0 && bkvh < (1LL << 31) && p.QG > 0 && p.QG <= 32 && p.G > 0 &&
      p.QG % p.G == 0 && p.group_rows >= 1 && p.group_rows <= kMaxRows &&
      p.n_split >= 1 && p.n_split <= kMaxSplits && p.chunk >= 1 &&
      (long long)p.n_split * p.chunk >= p.n_pos &&
      (p.n_split == 1 || (p.part != nullptr && p.part_ml != nullptr));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int B_KVH = static_cast<int>(bkvh);
  cudaError_t e = cudaErrorInvalidValue;
  if (D == 64)
    e = p.group_rows <= 4 ? launch<T, 4, 64>(p, B_KVH, st)
                          : launch<T, 8, 64>(p, B_KVH, st);
  else if (D == 128)
    e = p.group_rows <= 4 ? launch<T, 4, 128>(p, B_KVH, st)
                          : launch<T, 8, 128>(p, B_KVH, st);
  return static_cast<int>(e);
}

Params make_params(const void* q, int q_f32, const void* k, const void* v,
                   const void* ks, const void* vs, const void* table,
                   const void* lengths, void* out, int KVH, int QG, int G,
                   int page, int max_pages, int n_pos, int has_win, int win,
                   float scale, int has_cap, float cap, float inv_cap,
                   int n_split, int chunk, int group_rows, void* part,
                   void* part_ml) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.ks = static_cast<const __nv_bfloat16*>(ks);
  p.vs = static_cast<const __nv_bfloat16*>(vs);
  p.table = static_cast<const int32_t*>(table);
  p.lengths = static_cast<const int32_t*>(lengths);
  p.out = static_cast<float*>(out);
  p.part = static_cast<float*>(part);
  p.part_ml = static_cast<float*>(part_ml);
  p.q_f32 = q_f32;
  p.KVH = KVH;
  p.QG = QG;
  p.G = G;
  p.page = page;
  p.max_pages = max_pages;
  p.n_pos = n_pos;
  p.has_win = has_win;
  p.win = win;
  p.scale = scale;
  p.has_cap = has_cap;
  p.cap = cap;
  p.inv_cap = inv_cap;
  p.n_split = n_split;
  p.chunk = chunk;
  p.group_rows = group_rows;
  return p;
}

}  // namespace

// out[B, KVH, QG, D] fp32 from q[B, KVH, QG, D] (bf16, or fp32 when q_f32)
// and a bf16 cache: the slot cache [B, KVH, page = S, D] when table is
// null, else the pool [P, KVH, page, D] through table[B, max_pages].
// Positions t < n_pos are attended (attend_len, or max_pages * page),
// split into n_split chunks of `chunk` positions (n_split * chunk >=
// n_pos), query rows in groups of group_rows <= 8. With n_split > 1,
// part [n_split, B * KVH * QG, D] and part_ml [n_split, B * KVH * QG, 2]
// fp32 are the partials' scratch. D is 64 or 128, QG <= 32. Launches the
// split kernel and, when n_split > 1, the combine; allocates nothing and
// does not synchronise. Returns cudaGetLastError() after the launches.
extern "C" int qt_flash_decode_bf16(
    const void* q, int q_f32, const void* k, const void* v,
    const void* table, const void* lengths, void* out, int B, int KVH, int QG,
    int G, int D, int page, int max_pages, int n_pos, int has_win, int win,
    float scale, int has_cap, float cap, float inv_cap, int n_split,
    int chunk, int group_rows, void* part, void* part_ml, void* stream) {
  return dispatch<__nv_bfloat16>(
      make_params(q, q_f32, k, v, nullptr, nullptr, table, lengths, out, KVH,
                  QG, G, page, max_pages, n_pos, has_win, win, scale, has_cap,
                  cap, inv_cap, n_split, chunk, group_rows, part, part_ml),
      B, D, stream);
}

// The same over int8 codes with bf16 steps ks/vs laid out as the codes
// without D ([B, KVH, S] or [P, KVH, page]).
extern "C" int qt_flash_decode_i8(
    const void* q, int q_f32, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, const void* lengths, void* out, int B,
    int KVH, int QG, int G, int D, int page, int max_pages, int n_pos,
    int has_win, int win, float scale, int has_cap, float cap, float inv_cap,
    int n_split, int chunk, int group_rows, void* part, void* part_ml,
    void* stream) {
  return dispatch<int8_t>(
      make_params(q, q_f32, k, v, ks, vs, table, lengths, out, KVH, QG, G,
                  page, max_pages, n_pos, has_win, win, scale, has_cap, cap,
                  inv_cap, n_split, chunk, group_rows, part, part_ml),
      B, D, stream);
}
