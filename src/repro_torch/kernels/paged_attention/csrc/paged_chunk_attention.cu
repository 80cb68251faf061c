// Paged chunk attention for Hopper (sm_90a): attention of a chunk of t query
// tokens over a paged, copy-on-write KV pool plus the chunk's own K/V.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py,
// paged_chunk_attention_kernel (body _chunk_kernel).  Same function: the
// page walk goes through block_tables with every page redirected by page_map
// (a pending CoW destination reads its source page), cached positions are
// masked pos < lengths[b], int8 pools are dequantised per page and kv head,
// and the chunk's inline keys are attended causally (query row r, which is
// chunk token r / g, sees chunk keys 0 .. r / g).  f32 online softmax.
//
// What bounds it on an H100: the KV bytes read.  Decode (t = 1) does ~4
// flops per cached KV byte pair, far below the ~295 flop/byte ridge, so the
// floor is the cached K/V bytes over 3.35 TB/s.  The design reads each page
// once: one block per (sequence, kv head, tile of query rows) serves all g
// query heads of that kv head, so GQA never re-reads a page for another
// head.  Decode has few such blocks (batch x kv heads), so when the grid
// would not fill one wave of SMs the wrapper splits each row's pages into
// n_split ranges, one block each (grid z); every split writes its partial
// softmax state (max, sum, unnormalised accumulator) and
// paged_chunk_combine merges them.  Pages are staged with 16-byte loads.
// It does not yet use the tensor cores; PERF.md records how far it is from
// the floor.
//
// Unlike the TPU grid, which walks max_pages sequentially and relies on the
// table's zero padding, each block walks only pages below ceil(len/page) of
// its own table row, and rows of length 0 attend only to the chunk.
//
// The same walk, instantiated with kChunk = false, is the cached-only decode
// kernel paged_attention (entry point at the end of this file).  It replaces
// src/repro/kernels/paged_attention/kernel.py, paged_attention_kernel (body
// _kernel): one query token per row whose K/V is already in the pool,
// positions < lengths[b] attended, no page_map and no inline chunk.  It is
// bounded the same way, by the cached K/V bytes (at qwen2-1.5b's legacy
// decode step, b = 32 rows of ~1024 cached tokens, ~33.5 MB per layer,
// ~10 us), and uses the same split walk and combine.  The TPU kernel clamps
// the softmax sum to 1e-30 and so returns 0 for a row of length 0; here such
// a row has no visible key, its sum stays 0 and its output is written as 0.

#include "attention_tile.cuh"

#include <type_traits>

namespace repro_torch {

constexpr int PCA_WARPS = 4;
constexpr int PCA_ROWS_PER_WARP = 2;
constexpr int PCA_ROWS = PCA_WARPS * PCA_ROWS_PER_WARP;
constexpr int COMBINE_WARPS = 4;

// The body of both kernels below, run by a block of PCA_WARPS warps.
// q/out [b, t, kv, g, HD]; k_new/v_new [b, t, kv, HD];
// pools [n_pages, page, kv, HD]; block_tables [b, max_pages]; lengths [b];
// page_map [n_pages]; scales [n_pages, kv] (int8 pools only).
// With n_split > 1, split z writes part_m/part_l [z][row] and
// part_acc [z][row][HD] (row = output row index) instead of out.
// kChunk = false (cached-only decode): t = 1, k_new/v_new/page_map unused,
// pages read straight from block_tables, and a row with no visible key
// (length 0) is written as zeros.
template <int HD, typename T, typename PT, bool kChunk>
__device__ __forceinline__ void paged_walk(
    const T* __restrict__ q, const T* __restrict__ k_new, const T* __restrict__ v_new,
    const PT* __restrict__ k_pages, const PT* __restrict__ v_pages,
    const int* __restrict__ block_tables, const int* __restrict__ lengths,
    const int* __restrict__ page_map, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, T* __restrict__ out, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc, int b_total, int t, int kv, int g,
    int page, int max_pages, float scale) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int PV = 16 / sizeof(PT);  // pool elements per 16-byte load
  constexpr int CV = 16 / sizeof(T);   // chunk / q elements per 16-byte load
  __shared__ __align__(16) float q_s[PCA_ROWS][HD];
  __shared__ __align__(16) float k_s[KT][HD + 4];
  __shared__ __align__(16) float v_s[KT][HD];
  __shared__ int phys_s[KT];
  __shared__ float ksc_s[KT];
  __shared__ float vsc_s[KT];

  const int b = blockIdx.x / kv;
  const int kvh = blockIdx.x % kv;
  const int row0 = blockIdx.y * PCA_ROWS;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int n_rows = t * g;
  const int len = lengths[b];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nthreads = PCA_WARPS * 32;

  // q rows of this block: row r is chunk token r / g, query head r % g
  for (int e = threadIdx.x; e < PCA_ROWS * HD / CV; e += nthreads) {
    const int i = e / (HD / CV), d0 = (e % (HD / CV)) * CV, r = row0 + i;
    if (r < n_rows) {
      load16(q + ((((size_t)b * t + r / g) * kv + kvh) * g + r % g) * HD + d0, &q_s[i][d0],
             1.f);
    } else {
#pragma unroll
      for (int u = 0; u < CV; ++u) q_s[i][d0 + u] = 0.f;
    }
  }

  RowState<HD> st[PCA_ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < PCA_ROWS_PER_WARP; ++i) row_init(st[i]);

  // this split's share of the row's cached pages, through the block table
  // and the CoW redirect
  const int row_pages = (len + page - 1) / page;
  const int split_pages = (row_pages + n_split - 1) / n_split;
  const int pos_begin = min(len, split * split_pages * page);
  const int pos_end = min(len, (split + 1) * split_pages * page);
  const int* table = block_tables + (size_t)b * max_pages;
  for (int k0 = pos_begin; k0 < pos_end; k0 += KT) {
    __syncthreads();  // q staged / previous tile consumed
    if (threadIdx.x < KT) {
      const int pos = k0 + threadIdx.x;
      int phys = -1;
      float ksc = 1.f, vsc = 1.f;
      if (pos < pos_end) {
        phys = kChunk ? page_map[table[pos / page]] : table[pos / page];
        if constexpr (kQuant) {
          ksc = k_scales[(size_t)phys * kv + kvh];
          vsc = v_scales[(size_t)phys * kv + kvh];
        }
      }
      phys_s[threadIdx.x] = phys;
      ksc_s[threadIdx.x] = ksc;
      vsc_s[threadIdx.x] = vsc;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < KT * HD / PV; e += nthreads) {
      const int j = e / (HD / PV), d0 = (e % (HD / PV)) * PV;
      const int phys = phys_s[j];
      if (phys >= 0) {
        const size_t off = (((size_t)phys * page + (k0 + j) % page) * kv + kvh) * HD + d0;
        load16(k_pages + off, &k_s[j][d0], ksc_s[j]);
        load16(v_pages + off, &v_s[j][d0], vsc_s[j]);
      } else {
#pragma unroll
        for (int u = 0; u < PV; ++u) k_s[j][d0 + u] = v_s[j][d0 + u] = 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PCA_ROWS_PER_WARP; ++i) {
      const int li = warp * PCA_ROWS_PER_WARP + i;
      if (row0 + li >= n_rows) continue;  // warp-uniform
      fold_tile<HD>(st[i], q_s[li], &k_s[0][0], &v_s[0][0], k0 + lane < pos_end, scale);
    }
  }

  // the chunk's own keys, inline and causal (split 0 only); no row of this
  // block sees a chunk key beyond its last row's token
  const int r_last = min(n_rows, row0 + PCA_ROWS) - 1;
  const int j_end = kChunk && split == 0 ? min(t, r_last / g + 1) : 0;
  for (int j0 = 0; j0 < j_end; j0 += KT) {
    __syncthreads();
    for (int e = threadIdx.x; e < KT * HD / CV; e += nthreads) {
      const int j = e / (HD / CV), d0 = (e % (HD / CV)) * CV;
      if (j0 + j < t) {
        const size_t off = (((size_t)b * t + j0 + j) * kv + kvh) * HD + d0;
        load16(k_new + off, &k_s[j][d0], 1.f);
        load16(v_new + off, &v_s[j][d0], 1.f);
      } else {
#pragma unroll
        for (int u = 0; u < CV; ++u) k_s[j][d0 + u] = v_s[j][d0 + u] = 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PCA_ROWS_PER_WARP; ++i) {
      const int li = warp * PCA_ROWS_PER_WARP + i;
      const int r = row0 + li;
      if (r >= n_rows) continue;
      const int j = j0 + lane;
      fold_tile<HD>(st[i], q_s[li], &k_s[0][0], &v_s[0][0], j < t && j <= r / g, scale);
    }
  }

  const size_t n_out_rows = (size_t)b_total * t * kv * g;
#pragma unroll
  for (int i = 0; i < PCA_ROWS_PER_WARP; ++i) {
    const int r = row0 + warp * PCA_ROWS_PER_WARP + i;
    if (r >= n_rows) continue;
    const size_t row = (((size_t)b * t + r / g) * kv + kvh) * g + r % g;
    if (n_split == 1) {
      if (!kChunk && st[i].l == 0.f) {  // length 0: no key to attend
#pragma unroll
        for (int u = 0; u < HD / 32; ++u) out[row * HD + lane + 32 * u] = from_f32<T>(0.f);
      } else {
        row_store<HD, T>(st[i], out + row * HD);
      }
      continue;
    }
    // partial state; a split with no visible key leaves l = 0
    const size_t p = split * n_out_rows + row;
    if (lane == 0) {
      part_m[p] = st[i].m;
      part_l[p] = st[i].l;
    }
#pragma unroll
    for (int u = 0; u < HD / 32; ++u) part_acc[p * HD + lane + 32 * u] = st[i].acc[u];
  }
}

#define PCA_ARGS q, k_new, v_new, k_pages, v_pages, block_tables, lengths, page_map, k_scales, \
                 v_scales, out, part_m, part_l, part_acc, b_total, t, kv, g, page, max_pages, scale

template <int HD, typename T, typename PT>
__global__ void __launch_bounds__(PCA_WARPS * 32)
paged_chunk_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                             const T* __restrict__ v_new, const PT* __restrict__ k_pages,
                             const PT* __restrict__ v_pages, const int* __restrict__ block_tables,
                             const int* __restrict__ lengths, const int* __restrict__ page_map,
                             const float* __restrict__ k_scales,
                             const float* __restrict__ v_scales, T* __restrict__ out,
                             float* __restrict__ part_m, float* __restrict__ part_l,
                             float* __restrict__ part_acc, int b_total, int t, int kv, int g,
                             int page, int max_pages, float scale) {
  paged_walk<HD, T, PT, true>(PCA_ARGS);
}

template <int HD, typename T, typename PT>
__global__ void __launch_bounds__(PCA_WARPS * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                             const T* __restrict__ v_new, const PT* __restrict__ k_pages,
                             const PT* __restrict__ v_pages, const int* __restrict__ block_tables,
                             const int* __restrict__ lengths, const int* __restrict__ page_map,
                             const float* __restrict__ k_scales,
                             const float* __restrict__ v_scales, T* __restrict__ out,
                             float* __restrict__ part_m, float* __restrict__ part_l,
                             float* __restrict__ part_acc, int b_total, int t, int kv, int g,
                             int page, int max_pages, float scale) {
  paged_walk<HD, T, PT, false>(PCA_ARGS);
}

#undef PCA_ARGS

// Merge the splits of each output row: one warp per row.  A row whose
// splits all saw no key (cached-only decode of a length-0 row) is 0.
template <int HD, typename T>
__global__ void __launch_bounds__(COMBINE_WARPS * 32)
paged_chunk_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                           const float* __restrict__ part_acc, T* __restrict__ out,
                           int n_out_rows, int n_split) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * COMBINE_WARPS + (threadIdx.x >> 5);
  if (row >= n_out_rows) return;
  float m = neg_inf();
  for (int s = 0; s < n_split; ++s)
    if (part_l[(size_t)s * n_out_rows + row] > 0.f)
      m = fmaxf(m, part_m[(size_t)s * n_out_rows + row]);
  float l = 0.f, acc[HD / 32] = {};
  for (int s = 0; s < n_split; ++s) {
    const size_t p = (size_t)s * n_out_rows + row;
    const float ls = part_l[p];
    if (ls <= 0.f) continue;  // empty split: its accumulator was never written
    const float w = expf(part_m[p] - m);
    l = fmaf(ls, w, l);
#pragma unroll
    for (int u = 0; u < HD / 32; ++u) acc[u] = fmaf(w, part_acc[p * HD + lane + 32 * u], acc[u]);
  }
#pragma unroll
  for (int u = 0; u < HD / 32; ++u)
    out[(size_t)row * HD + lane + 32 * u] = from_f32<T>(l > 0.f ? acc[u] / l : 0.f);
}

struct Args {
  const void *q, *k_new, *v_new, *k_pages, *v_pages, *block_tables, *lengths, *page_map,
      *k_scales, *v_scales;
  void* out;
  float *part_m, *part_l, *part_acc;
  int b, t, kv, g, page, max_pages, n_split;
  float scale;
  cudaStream_t stream;
};

template <int HD, typename T, typename PT, bool kChunk = true>
static void launch(const Args& a) {
  const dim3 grid(a.b * a.kv, (a.t * a.g + PCA_ROWS - 1) / PCA_ROWS, a.n_split);
  auto kernel = paged_chunk_attention_kernel<HD, T, PT>;
  if constexpr (!kChunk) kernel = paged_attention_kernel<HD, T, PT>;
  kernel<<<grid, PCA_WARPS * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_new),
      static_cast<const T*>(a.v_new), static_cast<const PT*>(a.k_pages),
      static_cast<const PT*>(a.v_pages), static_cast<const int*>(a.block_tables),
      static_cast<const int*>(a.lengths), static_cast<const int*>(a.page_map),
      static_cast<const float*>(a.k_scales), static_cast<const float*>(a.v_scales),
      static_cast<T*>(a.out), a.part_m, a.part_l, a.part_acc, a.b, a.t, a.kv, a.g, a.page,
      a.max_pages, a.scale);
  if (a.n_split > 1) {
    const int rows = a.b * a.t * a.kv * a.g;
    paged_chunk_combine_kernel<HD, T>
        <<<(rows + COMBINE_WARPS - 1) / COMBINE_WARPS, COMBINE_WARPS * 32, 0, a.stream>>>(
            a.part_m, a.part_l, a.part_acc, static_cast<T*>(a.out), rows, a.n_split);
  }
}

template <int HD>
static void dispatch_dtype(int bf16, int quant, const Args& a) {
  if (bf16 && quant) launch<HD, __nv_bfloat16, int8_t>(a);
  else if (bf16) launch<HD, __nv_bfloat16, __nv_bfloat16>(a);
  else if (quant) launch<HD, float, int8_t>(a);
  else launch<HD, float, float>(a);
}

}  // namespace repro_torch

// C entry point for ctypes.  bf16 selects __nv_bfloat16 (else float) for q,
// the chunk and the output, and for the pools unless quant, which selects
// int8 pools with float scales.  n_split > 1 needs the f32 workspaces
// part_m, part_l [n_split * rows] and part_acc [n_split * rows * hd], with
// rows = b * t * kv * g.  Every pointer is 16-byte aligned.  Returns
// cudaGetLastError() after the launches.
extern "C" int paged_chunk_attention(const void* q, const void* k_new, const void* v_new,
                                     const void* k_pages, const void* v_pages,
                                     const void* block_tables, const void* lengths,
                                     const void* page_map, const void* k_scales,
                                     const void* v_scales, void* out, void* part_m,
                                     void* part_l, void* part_acc, int b, int t, int kv, int g,
                                     int hd, int page, int max_pages, int n_split, int bf16,
                                     int quant, float scale, void* stream) {
  using namespace repro_torch;
  const Args a{q, k_new, v_new, k_pages, v_pages, block_tables, lengths, page_map, k_scales,
               v_scales, out, static_cast<float*>(part_m), static_cast<float*>(part_l),
               static_cast<float*>(part_acc), b, t, kv, g, page, max_pages, n_split, scale,
               static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 32: dispatch_dtype<32>(bf16, quant, a); break;
    case 64: dispatch_dtype<64>(bf16, quant, a); break;
    case 128: dispatch_dtype<128>(bf16, quant, a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// C entry point of the cached-only decode kernel.  q/out [b, kv, g, hd];
// pools [n_pages, page, kv, hd] of q's type (bf16 selects __nv_bfloat16,
// else float); block_tables [b, max_pages]; lengths [b] (the token being
// decoded included).  n_split > 1 needs the f32 workspaces of
// paged_chunk_attention with rows = b * kv * g.  Returns cudaGetLastError()
// after the launches.
extern "C" int paged_attention(const void* q, const void* k_pages, const void* v_pages,
                               const void* block_tables, const void* lengths, void* out,
                               void* part_m, void* part_l, void* part_acc, int b, int kv, int g,
                               int hd, int page, int max_pages, int n_split, int bf16,
                               float scale, void* stream) {
  using namespace repro_torch;
  const Args a{q, nullptr, nullptr, k_pages, v_pages, block_tables, lengths, nullptr, nullptr,
               nullptr, out, static_cast<float*>(part_m), static_cast<float*>(part_l),
               static_cast<float*>(part_acc), b, 1, kv, g, page, max_pages, n_split, scale,
               static_cast<cudaStream_t>(stream)};
  switch (hd * 2 + (bf16 ? 1 : 0)) {
    case 64: launch<32, float, float, false>(a); break;
    case 65: launch<32, __nv_bfloat16, __nv_bfloat16, false>(a); break;
    case 128: launch<64, float, float, false>(a); break;
    case 129: launch<64, __nv_bfloat16, __nv_bfloat16, false>(a); break;
    case 256: launch<128, float, float, false>(a); break;
    case 257: launch<128, __nv_bfloat16, __nv_bfloat16, false>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
