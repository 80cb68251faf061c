// Causal GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// flash_attention_kernel (body _kernel).  Same function: softmax(q k^T /
// sqrt(hd)) v under a causal mask, with the KV head of query head h being
// h / g, so repeated KV is never materialised; f32 online softmax.  The TPU
// kernel asserts s % 128 == 0; these kernels mask the ragged tail, so a
// prompt of any length runs.  Every pointer is 16-byte aligned.
//
// What bounds it on an H100: the operations.  A causal prefill of s tokens
// does ~2 s^2 hd flops per head against ~4 s hd bytes per head, far above
// the ~295 flop/byte ridge, so the floor is the causal flops over the
// 989 TFLOP/s bf16 tensor-core rate.
//
// bf16 (flash_attention_tc_kernel): the tensor cores.  One warpgroup owns
// 64 query rows of one head; key tiles of 64 walk from the first to the
// diagonal one (the only one masked; tiles above it are skipped).
// * S = Q K^T: one wgmma m64n64k16 per 16 of hd, Q and K from shared
//   memory as TMA wrote them (128-byte swizzle; 64-byte, in 32-column
//   panels, for hd 32 and 160); the bf16 products are exact in the f32
//   accumulator.  hd 112 (zamba2-7b's shared block) is staged as hd 128:
//   its second 64-column box reaches past the tensor's last column, and
//   TMA fills those 16 columns with zeros, so Q K^T adds zero products,
//   P V writes zero columns, and only the 112 real columns are stored
//   (14% more tensor-core work than 112 needs, on the proven hd 128 path).
// * The online softmax runs in base 2 on the accumulator's fragment (a
//   thread holds two rows; row max and sum over the 4 lanes of a row).
// * O += P V: P, f32 in registers, is split into kPTerms bf16 terms (hi =
//   bf16(p), lo = bf16(p - hi)), each the register A operand of a wgmma
//   m64n{hd}k16 into the one f32 accumulator (hd 160: five m64n32k16, one
//   per 32-column panel); V is the B operand, N-major, from shared memory.  One term (P rounded to bf16) misses the f32-grade
//   tolerance by ~50x; two meet it with 5x to spare
//   (tests/test_torch_tc_numerics.py).  l sums the f32 P.
// * Loads: Q once, K/V tiles through a two-stage ring of TMA loads, each
//   stage tracked by an mbarrier, so tile j + 1 lands while tile j computes.
// * Grid: (query tiles, heads, batch), the heaviest (last) query tiles
//   first.  At qwen2-1.5b's prefill (b 1, 12 heads, 2 KV heads, hd 128) a
//   block takes 81 KB of shared memory, two fit an SM, and one wave holds
//   264 blocks: s = 128 gives 24 blocks and s = 1024 gives 192, so every
//   prefill is one partial wave.
// Left for later: a producer warp and two consumer warpgroups, overlapping
// the softmax of one tile with the products of the next, persistent
// scheduling over (head, tile), one KV tile feeding the g heads of a
// group, FP8.
//
// float32 (flash_attention_kernel): the CUDA cores, f32 throughout.  A lane
// scores one key of a 32-key tile staged in shared memory and a warp owns
// whole query rows; tiles above the diagonal are skipped.  A head dim that
// is not a whole number of 32 columns (112) is staged padded with zeros to
// the next one (128), and only its real columns are stored.

#include "attention_tile.cuh"
#include "hopper.cuh"

namespace repro_torch {

constexpr int FA_WARPS = 8;
constexpr int FA_ROWS_PER_WARP = 8;
constexpr int FA_ROWS = FA_WARPS * FA_ROWS_PER_WARP;  // 64-row query tile

// the head dim as staged: whole 32-column groups, one column per lane
template <int HD>
__host__ __device__ constexpr int fa_staged() { return (HD + 31) / 32 * 32; }

template <int HD>
constexpr size_t fa_smem_bytes() {
  constexpr int HP = fa_staged<HD>();
  return sizeof(float) * (FA_ROWS * HP + KT * (HP + 4) + KT * HP);
}

// q/out [b, s, h, HD]; k/v [b, s, kv, HD].  grid (q tiles, h, b).
template <int HD, typename T>
__global__ void __launch_bounds__(FA_WARPS * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int s, int h, int kv,
                       float scale) {
  constexpr int HP = fa_staged<HD>();    // staged columns, zero past HD
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                      // [FA_ROWS][HP]
  float* k_s = q_s + FA_ROWS * HP;        // [KT][HP + 4]
  float* v_s = k_s + KT * (HP + 4);       // [KT][HP]

  // heaviest (last) query tiles first: they have the most keys to walk
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / kv);
  const int row0 = tile * FA_ROWS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nthreads = FA_WARPS * 32;

  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  for (int e = threadIdx.x; e < FA_ROWS * HP / V; e += nthreads) {
    const int i = e / (HP / V), d0 = (e % (HP / V)) * V, r = row0 + i;
    if (r < s && d0 < HD) {
      load16(q + (((size_t)b * s + r) * h + head) * HD + d0, q_s + i * HP + d0, 1.f);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) q_s[i * HP + d0 + u] = 0.f;
    }
  }

  RowState<HP> st[FA_ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < FA_ROWS_PER_WARP; ++i) row_init(st[i]);

  // keys 0 .. last row of the tile: every tile at or below the diagonal
  const int k_end = min(s, row0 + FA_ROWS);
  for (int k0 = 0; k0 < k_end; k0 += KT) {
    __syncthreads();  // q staged / previous tile consumed
    for (int e = threadIdx.x; e < KT * HP / V; e += nthreads) {
      const int j = e / (HP / V), d0 = (e % (HP / V)) * V, pos = k0 + j;
      if (pos < s && d0 < HD) {
        const size_t off = (((size_t)b * s + pos) * kv + kvh) * HD + d0;
        load16(k + off, k_s + j * (HP + 4) + d0, 1.f);
        load16(v + off, v_s + j * HP + d0, 1.f);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) k_s[j * (HP + 4) + d0 + u] = v_s[j * HP + d0 + u] = 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < FA_ROWS_PER_WARP; ++i) {
      const int li = warp * FA_ROWS_PER_WARP + i;
      const int r = row0 + li;
      if (r >= s || k0 > r) continue;  // warp-uniform: past the end or above the diagonal
      fold_tile<HP>(st[i], q_s + li * HP, k_s, v_s, k0 + lane <= r, scale);
    }
  }

#pragma unroll
  for (int i = 0; i < FA_ROWS_PER_WARP; ++i) {
    const int r = row0 + warp * FA_ROWS_PER_WARP + i;
    if (r >= s) continue;
    row_store<HP, T, HD>(st[i], out + (((size_t)b * s + r) * h + head) * HD);
  }
}

namespace fa_tc {
using namespace hopper;

constexpr int ROWS = 64;     // query rows per block: wgmma's M
constexpr int KEYS = 64;     // keys per staged tile
constexpr int THREADS = 128;  // one warpgroup
constexpr int STAGES = 2;    // K/V ring
constexpr int kPTerms = 2;   // bf16 terms of P in O += P V
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Shape {
  // the head dim as staged: hd 112 as 128 (TMA zero-fills the last 16)
  static constexpr int HP = HD == 112 ? 128 : HD;
  // swizzle span, bytes: 128 where hd is whole 64-column panels, else
  // 64 (hd 32: one 32-column panel; hd 160: five)
  static constexpr int SW = HP % 64 == 0 ? 128 : 64;
  static constexpr int PE = SW / 2;               // hd columns per panel
  static constexpr int TILE = ROWS * HP * 2;      // bytes of one bf16 tile
  // alignment slack, Q, the K/V ring, mbarriers
  static constexpr size_t SMEM = 1024 + (1 + 2 * STAGES) * TILE + 8 * (1 + STAGES);
};

// out [b, s, h, HD] bf16; the maps cover q [b, s, h, HD] and k, v
// [b, s, kv, HD].  grid (query tiles, h, b), 128 threads.
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          __nv_bfloat16* __restrict__ out, int s, int h, int kv,
                          float scale_log2) {
  using Sh = Shape<HD>;
  constexpr int HP = Sh::HP, SW = Sh::SW, PE = Sh::PE, TILE = Sh::TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = base;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + (1 + 2 * STAGES) * TILE);

  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / kv);
  const int row0 = tile * ROWS;
  const int n_kv = tile + 1;  // key tiles 0 .. the diagonal one
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r_lo = warp * 16 + (lane >> 2);  // this thread's rows: r_lo, r_lo + 8

  auto k_s = [&](int st) { return base + (1 + 2 * st) * TILE; };
  auto v_s = [&](int st) { return base + (2 + 2 * st) * TILE; };
  auto load_kv = [&](int st, int j) {
    mbar_expect_tx(&bars[1 + st], 2 * TILE);
#pragma unroll
    for (int p = 0; p < HP / PE; ++p) {
      tma_load_4d(k_s(st) + p * KEYS * SW, &k_map, &bars[1 + st], p * PE, kvh, j * KEYS, b);
      tma_load_4d(v_s(st) + p * KEYS * SW, &v_map, &bars[1 + st], p * PE, kvh, j * KEYS, b);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 1 + STAGES; ++i) mbar_init(&bars[i], 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], TILE);
#pragma unroll
    for (int p = 0; p < HP / PE; ++p)
      tma_load_4d(q_s + p * ROWS * SW, &q_map, &bars[0], p * PE, head, row0, b);
    for (int j = 0; j < STAGES && j < n_kv; ++j) load_kv(j, j);
  }

  float o[HP / 2];
#pragma unroll
  for (int i = 0; i < HP / 2; ++i) o[i] = 0.f;
  float m0 = neg_inf(), m1 = neg_inf();  // running max of rows r_lo, r_lo + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's part of their sums
  mbar_wait(&bars[0], 0);

  for (int j = 0; j < n_kv; ++j) {
    const int st = j % STAGES;
    mbar_wait(&bars[1 + st], (j / STAGES) & 1);
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HP / 16; ++kk)
      wgmma_ss_n64<0, 0>(sc, kmajor_desc<SW>(q_s, kk * 16, ROWS),
                      kmajor_desc<SW>(k_s(st), kk * 16, KEYS));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // scores in base 2; on the diagonal tile key col of row `row` is
    // visible iff col <= row (key 0 always is, so every max is finite)
    const bool diag = j == tile;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = (i / 4) * 8 + (lane & 3) * 2 + (i & 1);
      const int row = r_lo + 8 * ((i >> 1) & 1);
      float t = sc[i] * scale_log2;
      if (diag && col > row) t = neg_inf();
      sc[i] = t;
      if ((i >> 1) & 1) mx1 = fmaxf(mx1, t); else mx0 = fmaxf(mx0, t);
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);  // 0 on the first tile
    m0 = mx0;
    m1 = mx1;
    uint32_t p_hi[16], p_lo[16];
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const bool hi_row = (i >> 1) & 1;
      const float m = hi_row ? m1 : m0;
      const float pa = exp2f(sc[i] - m), pb = exp2f(sc[i + 1] - m);
      if (hi_row) ls1 += pa + pb; else ls0 += pa + pb;
      split_pack(pa, pb, p_hi[i / 2], p_lo[i / 2]);
    }
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;
#pragma unroll
    for (int i = 0; i < HP / 2; ++i) o[i] *= ((i >> 1) & 1) ? a1 : a0;

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = nmajor_desc<SW>(v_s(st), kk * 16, KEYS);
      const uint32_t ah[4] = {p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2], p_hi[4 * kk + 3]};
      const uint32_t al[4] = {p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2], p_lo[4 * kk + 3]};
      if constexpr (HP == 128) {
        wgmma_rs_n128<1>(o, ah, dv);
        wgmma_rs_n128<1>(o, al, dv);
      } else if constexpr (HP == 64) {
        wgmma_rs_n64<1>(o, ah, dv);
        wgmma_rs_n64<1>(o, al, dv);
      } else {
        // 32-column panels (hd 32: one; hd 160: five), one m64n32 product
        // per panel into registers 16 p .. 16 p + 15 of o (columns 32 p ..)
#pragma unroll
        for (int p = 0; p < HP / PE; ++p) {
          float(&op)[16] = *reinterpret_cast<float(*)[16]>(o + 16 * p);
          const uint64_t dvp = nmajor_desc<SW>(v_s(st) + p * KEYS * SW, kk * 16, KEYS);
          wgmma_rs_n32<1>(op, ah, dvp);
          wgmma_rs_n32<1>(op, al, dvp);
        }
      }
    }
    static_assert(kPTerms == 2, "the P V loop issues a hi and a lo product");
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncthreads();  // every warp is done with stage st
    if (tid == 0 && j + STAGES < n_kv) load_kv(st, j + STAGES);
  }

#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
#pragma unroll
  for (int i = 0; i < HP / 2; i += 2) {
    const int row = r_lo + 8 * ((i >> 1) & 1);
    const int col = (i / 4) * 8 + (lane & 3) * 2;
    const int r = row0 + row;
    if (r >= s || col >= HD) continue;  // past the end, or a padded column
    const float l = ((i >> 1) & 1) ? l1 : l0;
    *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)b * s + r) * h + head) * HD + col) =
        __floats2bfloat162_rn(o[i] / l, o[i + 1] / l);
  }
}

template <int HD>
static int launch(const void* q, const void* k, const void* v, void* out, int b, int s, int h,
                  int kv, float scale, cudaStream_t stream) {
  using Sh = Shape<HD>;
  CUtensorMap q_map, k_map, v_map;
  const uint64_t qd[4] = {HD, (uint64_t)h, (uint64_t)s, (uint64_t)b};
  const uint64_t kd[4] = {HD, (uint64_t)kv, (uint64_t)s, (uint64_t)b};
  const uint32_t box[4] = {Sh::PE, 1, ROWS, 1};
  int err = make_tensor_map(&q_map, q, 4, qd, box, Sh::SW);
  if (!err) err = make_tensor_map(&k_map, k, 4, kd, box, Sh::SW);
  if (!err) err = make_tensor_map(&v_map, v, 4, kd, box, Sh::SW);
  if (err) return err;
  const cudaError_t attr = cudaFuncSetAttribute(flash_attention_tc_kernel<HD>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(Sh::SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((s + ROWS - 1) / ROWS, h, b);
  flash_attention_tc_kernel<HD><<<grid, THREADS, Sh::SMEM, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), s, h, kv, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fa_tc

template <int HD, typename T>
static int launch(const void* q, const void* k, const void* v, void* out, int b, int s, int h,
                  int kv, float scale, cudaStream_t stream) {
  constexpr size_t smem = fa_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<HD, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + FA_ROWS - 1) / FA_ROWS, h, b);
  flash_attention_kernel<HD, T><<<grid, FA_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s, h, kv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
static int dispatch_dtype(int bf16, const void* q, const void* k, const void* v, void* out,
                          int b, int s, int h, int kv, float scale, cudaStream_t stream) {
  return bf16 ? fa_tc::launch<HD>(q, k, v, out, b, s, h, kv, scale, stream)
              : launch<HD, float>(q, k, v, out, b, s, h, kv, scale, stream);
}

}  // namespace repro_torch

// C entry point for ctypes.  bf16 selects __nv_bfloat16 and the tensor-core
// kernel (else float and the CUDA-core one) for every tensor.  Returns the
// CUDA error of the tensor maps, the attribute call or the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out, int b,
                               int s, int h, int kv, int hd, int bf16, float scale,
                               void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return dispatch_dtype<32>(bf16, q, k, v, out, b, s, h, kv, scale, st);
    case 64: return dispatch_dtype<64>(bf16, q, k, v, out, b, s, h, kv, scale, st);
    case 112: return dispatch_dtype<112>(bf16, q, k, v, out, b, s, h, kv, scale, st);
    case 128: return dispatch_dtype<128>(bf16, q, k, v, out, b, s, h, kv, scale, st);
    case 160: return dispatch_dtype<160>(bf16, q, k, v, out, b, s, h, kv, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
