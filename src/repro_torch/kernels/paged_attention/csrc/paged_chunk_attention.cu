// Paged chunk attention for Hopper (sm_90a): attention of a chunk of t query
// tokens over a paged, copy-on-write KV pool plus the chunk's own K/V.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py,
// paged_chunk_attention_kernel (body _chunk_kernel).  Same function: the
// page walk goes through block_tables with every page redirected by page_map
// (a pending CoW destination reads its source page), cached positions are
// masked pos < lengths[b], int8 pools are dequantised per page and kv head,
// and the chunk's inline keys are attended causally (query row r, which is
// chunk token r / g, sees chunk keys 0 .. r / g).  Rows of length 0 attend
// only to the chunk.
//
// The same walk with kChunk = false is the cached-only decode kernel
// paged_attention (second entry point).  It replaces
// src/repro/kernels/paged_attention/kernel.py, paged_attention_kernel (body
// _kernel): one query token per row whose K/V is already in the pool,
// positions < lengths[b] attended, no page_map and no inline chunk.  The TPU
// kernel clamps the softmax sum to 1e-30 and so returns 0 for a row of
// length 0; here such a row has no visible key and is written as 0.
//
// What bounds both on an H100: the KV bytes read.  Decode (t = 1) does ~4
// flops per cached KV byte pair, far below the ~295 flop/byte ridge, so the
// floor is the cached K/V bytes over 3.35 TB/s.  Both designs below read a
// page once per (sequence, kv head, tile of query rows): the g query heads
// of a kv head are rows of one tile (GQA packed), so no page is re-read for
// another head.
//
// bf16 (paged_tc_kernel; int8 pools under bf16 q too): Hopper's tensor cores
// and a pipelined page walk, one launch per call.
// * Keys come in tiles of 16 (one page at page 16): the row's cached
//   positions, then (K1) the chunk keys the block's rows can see.  The
//   tiles are cut into n_split contiguous shares, one per block of a
//   thread-block cluster (grid z).
// * Blocks: up to 32 query rows (decode, verify), one warp per block and
//   16 rows (GQA packed: t * g rows of one kv head); more rows (suffix
//   prefill), four warps per block, each a 16-row slice of a 64-row tile,
//   so a page is read once per 64 rows.
// * Pages up front: a block first resolves the physical page of every
//   position of its share (page_map[table[p]] for K1, table[p] for K3)
//   and, for int8, both scales of each page, into shared memory; the walk
//   never waits on an index load.
// * A ring of stages (3 for a one-warp block, 4 for four warps) filled by
//   cp.async.cg 16-byte copies, K/V kept as stored (bf16 or int8), rows
//   padded by 16 bytes so ldmatrix and the int8 fragment loads are free of
//   bank conflicts.  Each lane computes one key's row address per tile and
//   the copies share it by shuffle.  Keys past the row's length are zero-
//   filled, never read.  Completion is cp.async.wait_group, so no copy can
//   be lost and nothing spins.
// * S = q k^T with mma.sync m16n8k16 (q in registers, K from ldmatrix or,
//   for int8, converted to bf16 exactly); the bf16 products are exact in
//   the f32 accumulator and the int8 k-scale multiplies the score.  The
//   online softmax runs in base 2 on the accumulator fragment.
// * O += P V: P (f32) times the int8 v-scale of its key (P (V s) = (P o s)
//   V) is split into kPTerms bf16 terms, hi = bf16(p), lo = bf16(p - hi),
//   each the A operand of an mma into the one f32 accumulator; V comes from
//   ldmatrix.trans (bf16) or byte loads (int8).  l sums the unscaled f32 P.
//   One term misses the f32-grade tolerance; two meet it
//   (tests/test_torch_tc_numerics.py).
// * The split combine is folded in: each block leaves its (m, l, acc) in
//   its shared memory; after a cluster barrier every block merges a share
//   of the rows from all the cluster's partials through distributed shared
//   memory and writes them; a second barrier keeps every block resident
//   until all have read.
// Why mma.sync and not wgmma: a decode tile has 6 real rows of wgmma's 64,
// and the walk is bound by bytes; mma.sync's 16 rows waste less, need no
// swizzled layout, and let one warp walk its own pages.  Where the time
// goes (tools/k1_profile.py): a fixed cost of ~5 us per call (the
// dependent lengths -> table -> page_map loads, the first tile's latency,
// the two cluster barriers), then ~1.5 us per 16-key tile and warp
// (issuing its copies, waiting, the products), which at decode leaves the
// walk near the HBM rate only where enough warps share an SM.  Staging a
// tile as 32 one-dimensional bulk copies of a row each (one instruction a
// lane, completing on an mbarrier) was tried and was slower at every shape.

// float32 (paged_chunk_attention_kernel / paged_attention_kernel): the CUDA
// cores, f32 throughout: one block per (sequence, kv head, tile of 8 query
// rows), 32-key tiles staged as f32 in shared memory, a lane per key; when
// the grid would not fill one wave of SMs the walk is split over grid z,
// each split writes its partial softmax state and paged_chunk_combine
// merges them (a second launch).
//
// Head dims 32, 64, 128 and 160 (stablelm-12b).  At 160 a bf16 key row is
// 320 bytes (336 with its pad, still 16-byte aligned and free of ldmatrix
// bank conflicts), Q K^T takes 10 k16 steps and P V 20 n8 tiles per 16
// rows; the f32 walk's staged tile (46 KB) stays under the 48 KB of static
// shared memory, and a 64-row partial (41.5 KB) fits its 42 KB ring.

#include "attention_tile.cuh"
#include "hopper.cuh"

#include <cooperative_groups.h>

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core walk
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;
using hopper::cp_async16;
using hopper::mma_16816;

constexpr int kPTerms = 2;           // bf16 terms of P in O += P V
constexpr int TC_WARPS = 4;          // warps of a block of the 64-row tile
constexpr int TC_KEYS = 16;          // keys per staged tile
constexpr int TC_STAGES_WARP = 3;    // ring depth of a one-warp block (rows <= 32)
constexpr int TC_STAGES_BLOCK = 4;   // ring depth of a 64-row block (rows > 32)
constexpr int TC_ONE_WARP_ROWS = 32; // the most rows served by one-warp blocks
constexpr float TC_LOG2E = 1.4426950408889634f;
constexpr int MAX_CLUSTER = 16;      // blocks of a cluster (above 8: non-portable)
constexpr int MAX_DEVICES = 64;      // cards whose function attributes are cached

// Bytes of one staged tile (K rows, then V rows, each padded by 16 bytes),
// sized for bf16 so that it also holds an int8 tile.
template <int HD>
__host__ __device__ constexpr int tc_stage_bytes() {
  return 2 * TC_KEYS * (HD * 2 + 16);
}
template <int HD, bool kOneWarp>
__host__ __device__ constexpr int tc_ring_bytes() {
  return (kOneWarp ? TC_STAGES_WARP : TC_STAGES_BLOCK) * tc_stage_bytes<HD>();
}
// A softmax partial of R rows, in floats: m[R], l[R], acc[R][HD].
template <int HD>
__host__ __device__ constexpr int tc_partial_floats(int rows) {
  return rows * (HD + 2);
}
// Bytes of the resolved-page table at the front of shared memory (page id,
// and for int8 its k and v scale), rounded to 128.
__host__ __device__ constexpr int tc_pages_bytes(int np_max, bool quant) {
  return (np_max * (quant ? 12 : 4) + 127) & ~127;
}

struct TcParams {
  const void *q, *k_new, *v_new, *k_pages, *v_pages;
  const int *block_tables, *lengths, *page_map;
  const float *k_scales, *v_scales;
  __nv_bfloat16* out;
  int t, kv, g, page, max_pages, np_max;
  float c;  // softmax scale * log2(e)
};

// Online-softmax state of one warp's 16 query rows.  Lane l holds rows
// r = l / 4 and r + 8 (h = 0, 1): o[n][2 h], o[n][2 h + 1] are dims 8 n +
// 2 (l % 4) .. + 1 of row r + 8 h (the mma accumulator layout).
template <int HD>
struct WarpRows {
  float o[HD / 8][4];
  float m[2];  // running max of the scores, base 2
  float l[2];  // this lane's share of the running sum
};

// Copy one tile of 16 keys (K and V rows of element type E) into `stage`
// with the NTH threads gtid = 0 .. NTH - 1 of a group (whole warps).
// row_of(key, &off) gives the element offset of the key's row in k/v, or
// false for a key past the end (zeroed, not read); lane k of each warp
// computes it once for key k % 16, the copies fetch it by shuffle, and the
// K and V chunks of one key and column go together.
template <int HD, typename E, int NTH, typename RowOf>
__device__ __forceinline__ void stage_tile(uint8_t* stage, const E* k, const E* v, RowOf row_of,
                                           int gtid) {
  constexpr int RS = HD * sizeof(E) + 16;
  constexpr int CPR = HD * sizeof(E) / 16;  // 16-byte chunks per key row
  constexpr int N = TC_KEYS * CPR;          // chunks of K (and of V)
  const int lane = threadIdx.x & 31;
  long long my_off = 0;
  const bool my_valid = row_of(lane & (TC_KEYS - 1), my_off);
  const unsigned valid = __ballot_sync(0xffffffffu, my_valid);
#pragma unroll
  for (int i = 0; i < (N + NTH - 1) / NTH; ++i) {
    const int e = gtid + i * NTH;
    const int key = (e / CPR) % TC_KEYS, ch = e % CPR;
    const long long off = __shfl_sync(0xffffffffu, my_off, key) + ch * (16 / sizeof(E));
    const bool ok = (valid >> key) & 1;
    if (N % NTH == 0 || e < N) {
      uint8_t* dst = stage + key * RS + ch * 16;
      cp_async16(dst, k + off, ok);
      cp_async16(dst + TC_KEYS * RS, v + off, ok);
    }
  }
}

// Fold one staged tile into a warp's rows.  qa: the rows' q fragments;
// lim[h]: keys below it are visible to row h; cs: score scale of the
// lane's 4 keys (8 nb + 2 (l % 4) + i, index 2 nb + i: c times the int8
// k-scale); vs: their v-scales (1 unless int8).
template <int HD, typename E>
__device__ __forceinline__ void fold_keys(WarpRows<HD>& st, const uint32_t (&qa)[HD / 16][4],
                                          const uint8_t* stage, const int (&lim)[2],
                                          const float (&cs)[4], const float (&vs)[4]) {
  constexpr bool kInt8 = std::is_same<E, int8_t>::value;
  constexpr int RS = HD * sizeof(E) + 16;
  const uint8_t* ks = stage;
  const uint8_t* vsm = stage + TC_KEYS * RS;
  const int lane = threadIdx.x & 31, r = lane >> 2, c = 2 * (lane & 3), j = lane >> 3;

  float s[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t b[4];
    if constexpr (kInt8) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int8_t* row = reinterpret_cast<const int8_t*>(ks + (8 * nb + r) * RS) + 16 * kk + c;
        const char2 lo = *reinterpret_cast<const char2*>(row);
        const char2 hi = *reinterpret_cast<const char2*>(row + 8);
        b[2 * nb] = hopper::int8x2_bf16x2(lo.x, lo.y);
        b[2 * nb + 1] = hopper::int8x2_bf16x2(hi.x, hi.y);
      }
    } else {
      // matrices: keys 0-7 / dims lo, keys 0-7 / hi, keys 8-15 / lo, 8-15 / hi
      hopper::ldmatrix_x4<false>(b, ks + ((j >> 1) * 8 + (lane & 7)) * RS +
                                        (16 * kk + (j & 1) * 8) * 2);
    }
    mma_16816(s[0], qa[kk], b[0], b[1]);
    mma_16816(s[1], qa[kk], b[2], b[3]);
  }

  float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      s[nb][e] = 8 * nb + c + (e & 1) < lim[h] ? s[nb][e] * cs[2 * nb + (e & 1)] : neg_inf();
      mx[h] = fmaxf(mx[h], s[nb][e]);
    }
  float mu[2], alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float mn = fmaxf(st.m[h], mx[h]);
    mu[h] = mn == neg_inf() ? 0.f : mn;  // no visible key yet: p = 0, not NaN
    alpha[h] = exp2f(st.m[h] - mu[h]);
    st.m[h] = mn;
  }
  float p[2][4], psum[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[nb][e] = exp2f(s[nb][e] - mu[e >> 1]);
      psum[e >> 1] += p[nb][e];
      p[nb][e] *= vs[2 * nb + (e & 1)];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) st.l[h] = st.l[h] * alpha[h] + psum[h];
  if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {  // some max moved
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      st.o[n][0] *= alpha[0];
      st.o[n][1] *= alpha[0];
      st.o[n][2] *= alpha[1];
      st.o[n][3] *= alpha[1];
    }
  }
  // P as the A operand (rows r, r + 8; keys c.., 8 + c..), split in two
  static_assert(kPTerms == 2, "the P V loop issues a hi and a lo product");
  uint32_t hi[4], lo[4];
  hopper::split_pack(p[0][0], p[0][1], hi[0], lo[0]);
  hopper::split_pack(p[0][2], p[0][3], hi[1], lo[1]);
  hopper::split_pack(p[1][0], p[1][1], hi[2], lo[2]);
  hopper::split_pack(p[1][2], p[1][3], hi[3], lo[3]);
#pragma unroll
  for (int nd = 0; nd < HD / 16; ++nd) {
    uint32_t b[4];  // b[0], b[1]: dims 16 nd .. + 7; b[2], b[3]: the next 8
    if constexpr (kInt8) {
      const int8_t* vr = reinterpret_cast<const int8_t*>(vsm);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 16 * nd + 8 * half + r;
        b[2 * half] = hopper::int8x2_bf16x2(vr[c * RS + n], vr[(c + 1) * RS + n]);
        b[2 * half + 1] = hopper::int8x2_bf16x2(vr[(c + 8) * RS + n], vr[(c + 9) * RS + n]);
      }
    } else {
      // matrices (transposed): keys 0-7 / dims lo, 8-15 / lo, 0-7 / hi, 8-15 / hi
      hopper::ldmatrix_x4<true>(b, vsm + ((j & 1) * 8 + (lane & 7)) * RS +
                                       (16 * nd + (j >> 1) * 8) * 2);
    }
    mma_16816(st.o[2 * nd], hi, b[0], b[1]);
    mma_16816(st.o[2 * nd], lo, b[0], b[1]);
    mma_16816(st.o[2 * nd + 1], hi, b[2], b[3]);
    mma_16816(st.o[2 * nd + 1], lo, b[2], b[3]);
  }
}

// Merge rows [r_lo, r_hi) of n_src (<= MAX_SRC) partials of R rows (src(s)
// -> its m[R], l[R], acc[R][HD]) in the order s = 0, 1, ...; a partial with
// l = 0 saw no key and is skipped.  Every source's values are loaded before
// any is used, so the loads (remote ones included) overlap.  sink(row, d,
// m, l, acc4) takes dims d .. d + 3 of each merged row.
template <int HD, int MAX_SRC, int NTH, typename Src, typename Sink>
__device__ __forceinline__ void merge_partials(int n_src, int R, int r_lo, int r_hi, Src src,
                                               Sink sink) {
  for (int e = threadIdx.x; e < (r_hi - r_lo) * (HD / 4); e += NTH) {
    const int row = r_lo + e / (HD / 4), d = (e % (HD / 4)) * 4;
    float m[MAX_SRC], l[MAX_SRC];
    float4 a[MAX_SRC];
#pragma unroll
    for (int s = 0; s < MAX_SRC; ++s) {
      l[s] = 0.f;
      if (s < n_src) {
        const float* P = src(s);
        m[s] = P[row];
        l[s] = P[R + row];
        a[s] = *reinterpret_cast<const float4*>(P + 2 * R + row * HD + d);
      }
    }
    float mx = neg_inf();
#pragma unroll
    for (int s = 0; s < MAX_SRC; ++s)
      if (l[s] > 0.f) mx = fmaxf(mx, m[s]);
    float lsum = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < MAX_SRC; ++s) {
      if (l[s] <= 0.f) continue;
      const float w = exp2f(m[s] - mx);
      lsum = fmaf(l[s], w, lsum);
      acc.x = fmaf(w, a[s].x, acc.x);
      acc.y = fmaf(w, a[s].y, acc.y);
      acc.z = fmaf(w, a[s].z, acc.z);
      acc.w = fmaf(w, a[s].w, acc.w);
    }
    sink(row, d, mx, lsum, acc);
  }
}

// grid (b * kv, row tiles, n_split), cluster (1, 1, n_split).  kOneWarp:
// blocks of one warp and 16 rows; else four warps, each a 16-row slice of a
// 64-row tile.  Shared memory: the resolved pages, then the ring (reused
// for the block's partial once the walk is done).
template <int HD, typename PT, bool kChunk, bool kOneWarp>
__global__ void __launch_bounds__(kOneWarp ? 32 : 32 * TC_WARPS)
paged_tc_kernel(const TcParams p) {
  using T = __nv_bfloat16;
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int NTH = kOneWarp ? 32 : 32 * TC_WARPS;
  constexpr int ROWS = kOneWarp ? 16 : 16 * TC_WARPS;
  constexpr int STAGES = kOneWarp ? TC_STAGES_WARP : TC_STAGES_BLOCK;
  constexpr int STAGE = tc_stage_bytes<HD>();
  static_assert(tc_partial_floats<HD>(ROWS) * 4 <= tc_ring_bytes<HD, kOneWarp>(),
                "the partial fits in the ring");
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_split = static_cast<int>(cluster.num_blocks());

  const int kv = p.kv, g = p.g, t = p.t, page = p.page;
  const int b = blockIdx.x / kv, kvh = blockIdx.x % kv;
  const int row0 = blockIdx.y * ROWS, n_rows = t * g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = p.lengths[b];

  // The block's key tiles: the cached positions, then the chunk keys its
  // rows can see; this rank takes a contiguous share of them.
  const int nc = (len + TC_KEYS - 1) / TC_KEYS;
  const int j_end = kChunk ? min(t, (min(n_rows, row0 + ROWS) - 1) / g + 1) : 0;
  const int n_tiles = nc + (j_end + TC_KEYS - 1) / TC_KEYS;
  const int per = (n_tiles + n_split - 1) / n_split;
  const int tile_begin = min(n_tiles, rank * per), tile_end = min(n_tiles, tile_begin + per);

  // Resolve the pages of this rank's cached tiles (and their scales) once.
  int* phys_s = reinterpret_cast<int*>(smem);
  float* ksc_s = reinterpret_cast<float*>(phys_s + p.np_max);
  float* vsc_s = ksc_s + p.np_max;
  const int pos_lo = tile_begin * TC_KEYS, pos_hi = min(len, min(tile_end, nc) * TC_KEYS);
  const int pg_lo = pos_lo / page;
  const int n_pg = pos_hi > pos_lo ? (pos_hi - 1) / page + 1 - pg_lo : 0;
  const int* table = p.block_tables + (size_t)b * p.max_pages;
  for (int i = threadIdx.x; i < n_pg; i += NTH) {
    int phys = table[pg_lo + i];
    if constexpr (kChunk) phys = p.page_map[phys];
    phys_s[i] = phys;
    if constexpr (kQuant) {
      ksc_s[i] = p.k_scales[(size_t)phys * kv + kvh];
      vsc_s[i] = p.v_scales[(size_t)phys * kv + kvh];
    }
  }
  uint8_t* ring = smem + tc_pages_bytes(p.np_max, kQuant);

  // q fragments of this warp's 16 rows (zero past the last row)
  const int r = lane >> 2, c = 2 * (lane & 3);
  const T* q = static_cast<const T*>(p.q);
  uint32_t qa[HD / 16][4];
  int vis[2];  // chunk keys visible to the lane's rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rg = row0 + 16 * warp + r + 8 * h;
    vis[h] = min(t, rg / g + 1);
    const T* qrow = q + ((((size_t)b * t + rg / g) * kv + kvh) * g + rg % g) * HD;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][h] = rg < n_rows ? __ldg(reinterpret_cast<const unsigned*>(qrow + 16 * kk + c)) : 0u;
      qa[kk][2 + h] =
          rg < n_rows ? __ldg(reinterpret_cast<const unsigned*>(qrow + 16 * kk + 8 + c)) : 0u;
    }
  }
  WarpRows<HD> st;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) st.o[n][0] = st.o[n][1] = st.o[n][2] = st.o[n][3] = 0.f;
  st.m[0] = st.m[1] = neg_inf();
  st.l[0] = st.l[1] = 0.f;
  __syncthreads();  // pages resolved

  // The walk: the block's threads fill one ring; every warp folds every
  // tile into its own rows.
  const int count = tile_end - tile_begin;
  const bool active = row0 + 16 * warp < n_rows;  // warp-uniform
  const PT* k_pool = static_cast<const PT*>(p.k_pages);
  const PT* v_pool = static_cast<const PT*>(p.v_pages);

  auto issue = [&](int i) {
    const int tile = tile_begin + i;
    uint8_t* stage = ring + (i % STAGES) * STAGE;
    if (tile < nc) {
      const int pos0 = tile * TC_KEYS;
      stage_tile<HD, PT, NTH>(stage, k_pool, v_pool, [&](int key, long long& off) {
        const int pos = pos0 + key;
        if (pos >= len) return false;
        off = (((long long)phys_s[pos / page - pg_lo] * page + pos % page) * kv + kvh) * HD;
        return true;
      }, threadIdx.x);
    } else if constexpr (kChunk) {
      const int j0 = (tile - nc) * TC_KEYS;
      stage_tile<HD, T, NTH>(stage, static_cast<const T*>(p.k_new),
                             static_cast<const T*>(p.v_new), [&](int key, long long& off) {
                               if (j0 + key >= t) return false;
                               off = (((long long)b * t + j0 + key) * kv + kvh) * HD;
                               return true;
                             }, threadIdx.x);
    }
  };
  auto fold = [&](int i) {
    const int tile = tile_begin + i;
    const uint8_t* stage = ring + (i % STAGES) * STAGE;
    if (tile < nc) {
      const int pos0 = tile * TC_KEYS;
      const int lim[2] = {len - pos0, len - pos0};
      float cs[4], vs[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int pos = pos0 + 8 * (u >> 1) + c + (u & 1);
        cs[u] = p.c;
        vs[u] = 1.f;
        if constexpr (kQuant) {
          if (pos < len) {
            const int pi = pos / page - pg_lo;
            cs[u] = p.c * ksc_s[pi];
            vs[u] = vsc_s[pi];
          }
        }
      }
      fold_keys<HD, PT>(st, qa, stage, lim, cs, vs);
    } else if constexpr (kChunk) {
      const int j0 = (tile - nc) * TC_KEYS;
      const int lim[2] = {vis[0] - j0, vis[1] - j0};
      const float cs[4] = {p.c, p.c, p.c, p.c}, vs[4] = {1.f, 1.f, 1.f, 1.f};
      fold_keys<HD, T>(st, qa, stage, lim, cs, vs);
    }
  };
  auto group_sync = [&]() {
    if constexpr (kOneWarp) __syncwarp();
    else __syncthreads();
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < count) issue(i);
    hopper::cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    hopper::cp_async_wait<STAGES - 2>();  // tile i landed (this thread's part)
    group_sync();                         // ... everyone's; tile i - 1 consumed
    if (i + STAGES - 1 < count) issue(i + STAGES - 1);
    hopper::cp_async_commit();
    if (active) fold(i);
  }
  hopper::cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // this warp's rows into the block's partial
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], 1);
    st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], 2);
  }
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * warp + r + 8 * h;
    if ((lane & 3) == 0) {
      part[row] = st.m[h];
      part[ROWS + row] = st.l[h];
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(part + 2 * ROWS + row * HD + 8 * n + c) =
          make_float2(st.o[n][2 * h], st.o[n][2 * h + 1]);
  }

  // the cluster's partials: every rank merges a share of the rows from all
  // ranks' shared memory (distributed shared memory) and writes them; the
  // second barrier (relaxed: it publishes nothing) keeps every block
  // resident until all have read
  cluster.sync();
  const int real_rows = min(ROWS, n_rows - row0);
  const int share = (real_rows + n_split - 1) / n_split;
  merge_partials<HD, MAX_CLUSTER, NTH>(
      n_split, ROWS, min(real_rows, rank * share), min(real_rows, (rank + 1) * share),
      [&](int s) { return cluster.map_shared_rank(part, s); },
      [&](int row, int d, float, float l, float4 acc) {
        const int rg = row0 + row;
        T* o = p.out + ((((size_t)b * t + rg / g) * kv + kvh) * g + rg % g) * HD + d;
        // a row with no visible key (K3 at length 0) is 0
        const float4 v = l > 0.f ? make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        const __nv_bfloat162 lo2 = __floats2bfloat162_rn(v.x, v.y);
        const __nv_bfloat162 hi2 = __floats2bfloat162_rn(v.z, v.w);
        uint2 packed;
        packed.x = *reinterpret_cast<const uint32_t*>(&lo2);
        packed.y = *reinterpret_cast<const uint32_t*>(&hi2);
        *reinterpret_cast<uint2*>(o) = packed;
      });
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\nbarrier.cluster.wait.aligned;\n" :::
                   "memory");
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

template <int HD, typename PT, bool kChunk, bool kOneWarp>
static int launch_tc_rows(const Args& a) {
  constexpr int ROWS = kOneWarp ? 16 : 16 * TC_WARPS;
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  if (a.n_split < 1 || a.n_split > MAX_CLUSTER) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged_tc_kernel<HD, PT, kChunk, kOneWarp>;
  // the most pages a rank's share of the key tiles can touch
  const int tiles_max = (a.max_pages * a.page + TC_KEYS - 1) / TC_KEYS + (a.t + TC_KEYS - 1) / TC_KEYS;
  const int per = (tiles_max + a.n_split - 1) / a.n_split;
  const int np_max = (per * TC_KEYS + a.page - 1) / a.page + 1;
  const size_t smem = tc_pages_bytes(np_max, kQuant) + tc_ring_bytes<HD, kOneWarp>();
  // set once per instantiation and card (a function's attributes are the
  // current card's): the launch itself adds no host work
  static size_t smem_set[MAX_DEVICES] = {};
  static bool non_portable[MAX_DEVICES] = {};
  int dev = 0;
  const cudaError_t dev_err = cudaGetDevice(&dev);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = smem;
  }
  if (a.n_split > 8 && !non_portable[dev]) {  // clusters above 8 blocks are not portable
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    non_portable[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.b * a.kv, (a.t * a.g + ROWS - 1) / ROWS, a.n_split);
  cfg.blockDim = dim3(kOneWarp ? 32 : 32 * TC_WARPS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = a.n_split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const TcParams p{a.q, a.k_new, a.v_new, a.k_pages, a.v_pages,
                   static_cast<const int*>(a.block_tables), static_cast<const int*>(a.lengths),
                   static_cast<const int*>(a.page_map), static_cast<const float*>(a.k_scales),
                   static_cast<const float*>(a.v_scales), static_cast<__nv_bfloat16*>(a.out),
                   a.t, a.kv, a.g, a.page, a.max_pages, np_max, a.scale * TC_LOG2E};
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// bf16 q: up to 32 rows in one-warp blocks of 16 rows; more rows in blocks
// of four warps over 64-row tiles.
template <int HD, typename PT, bool kChunk>
static int launch_tc(const Args& a) {
  return a.t * a.g <= TC_ONE_WARP_ROWS ? launch_tc_rows<HD, PT, kChunk, true>(a)
                                       : launch_tc_rows<HD, PT, kChunk, false>(a);
}

// float32 q: the CUDA-core walk, and the combine kernel when split.
template <int HD, typename PT, bool kChunk = true>
static int launch_f32(const Args& a) {
  using T = float;
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
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
static int dispatch_dtype(int bf16, int quant, const Args& a) {
  if (bf16 && quant) return launch_tc<HD, int8_t, true>(a);
  if (bf16) return launch_tc<HD, __nv_bfloat16, true>(a);
  if (quant) return launch_f32<HD, int8_t>(a);
  return launch_f32<HD, float>(a);
}

}  // namespace repro_torch

// C entry point for ctypes.  bf16 selects __nv_bfloat16 (else float) for q,
// the chunk and the output, and for the pools unless quant, which selects
// int8 pools with float scales.  bf16 runs the tensor-core walk, one
// cluster launch whatever n_split (at most 16).  float32 with n_split > 1
// needs the f32 workspaces part_m, part_l [n_split * rows] and part_acc
// [n_split * rows * hd], with rows = b * t * kv * g.  Every pointer is
// 16-byte aligned.  Returns the launch's error or cudaGetLastError().
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
    case 32: return dispatch_dtype<32>(bf16, quant, a);
    case 64: return dispatch_dtype<64>(bf16, quant, a);
    case 128: return dispatch_dtype<128>(bf16, quant, a);
    case 160: return dispatch_dtype<160>(bf16, quant, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C entry point of the cached-only decode kernel.  q/out [b, kv, g, hd];
// pools [n_pages, page, kv, hd] of q's type (bf16 selects __nv_bfloat16 and
// the tensor-core walk, else float); block_tables [b, max_pages]; lengths
// [b] (the token being decoded included).  float32 with n_split > 1 needs
// the f32 workspaces of paged_chunk_attention with rows = b * kv * g.
// Returns the launch's error or cudaGetLastError().
extern "C" int paged_attention(const void* q, const void* k_pages, const void* v_pages,
                               const void* block_tables, const void* lengths, void* out,
                               void* part_m, void* part_l, void* part_acc, int b, int kv, int g,
                               int hd, int page, int max_pages, int n_split, int bf16,
                               float scale, void* stream) {
  using namespace repro_torch;
  using bf = __nv_bfloat16;
  const Args a{q, nullptr, nullptr, k_pages, v_pages, block_tables, lengths, nullptr, nullptr,
               nullptr, out, static_cast<float*>(part_m), static_cast<float*>(part_l),
               static_cast<float*>(part_acc), b, 1, kv, g, page, max_pages, n_split, scale,
               static_cast<cudaStream_t>(stream)};
  switch (hd * 2 + (bf16 ? 1 : 0)) {
    case 64: return launch_f32<32, float, false>(a);
    case 65: return launch_tc<32, bf, false>(a);
    case 128: return launch_f32<64, float, false>(a);
    case 129: return launch_tc<64, bf, false>(a);
    case 256: return launch_f32<128, float, false>(a);
    case 257: return launch_tc<128, bf, false>(a);
    case 320: return launch_f32<160, float, false>(a);
    case 321: return launch_tc<160, bf, false>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
