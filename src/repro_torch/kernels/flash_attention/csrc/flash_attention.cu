// Causal GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// flash_attention_kernel (body _kernel).  Same function: softmax(q k^T /
// sqrt(hd)) v under a causal mask, with the KV head of query head h being
// h / g, so repeated KV is never materialised; f32 online softmax.  The TPU
// kernel asserts s % 128 == 0; this one masks the ragged tail itself, so a
// prompt of any length runs.  Every pointer is 16-byte aligned (tiles are
// staged with 16-byte loads).
//
// What bounds it on an H100: the operations.  A causal prefill of s tokens
// does ~2 s^2 hd flops per head against ~4 s hd bytes per head, far above
// the ~295 flop/byte ridge, so the floor is the causal flops over the
// 989 TFLOP/s bf16 tensor-core rate.  This first design computes in f32 on
// the CUDA cores (a lane scores one key of a 32-key tile staged in shared
// memory, a warp owns whole query rows) and skips every tile above the
// diagonal.  It leaves the tensor cores (wgmma), TMA staging and the sharing
// of one KV tile between the g heads of a group to later work; PERF.md
// records how far that leaves it from the floor.

#include "attention_tile.cuh"

namespace repro_torch {

constexpr int FA_WARPS = 8;
constexpr int FA_ROWS_PER_WARP = 8;
constexpr int FA_ROWS = FA_WARPS * FA_ROWS_PER_WARP;  // 64-row query tile

template <int HD>
constexpr size_t fa_smem_bytes() {
  return sizeof(float) * (FA_ROWS * HD + KT * (HD + 4) + KT * HD);
}

// q/out [b, s, h, HD]; k/v [b, s, kv, HD].  grid (q tiles, h, b).
template <int HD, typename T>
__global__ void __launch_bounds__(FA_WARPS * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int s, int h, int kv,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                      // [FA_ROWS][HD]
  float* k_s = q_s + FA_ROWS * HD;        // [KT][HD + 4]
  float* v_s = k_s + KT * (HD + 4);       // [KT][HD]

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
  for (int e = threadIdx.x; e < FA_ROWS * HD / V; e += nthreads) {
    const int i = e / (HD / V), d0 = (e % (HD / V)) * V, r = row0 + i;
    if (r < s) {
      load16(q + (((size_t)b * s + r) * h + head) * HD + d0, q_s + i * HD + d0, 1.f);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) q_s[i * HD + d0 + u] = 0.f;
    }
  }

  RowState<HD> st[FA_ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < FA_ROWS_PER_WARP; ++i) row_init(st[i]);

  // keys 0 .. last row of the tile: every tile at or below the diagonal
  const int k_end = min(s, row0 + FA_ROWS);
  for (int k0 = 0; k0 < k_end; k0 += KT) {
    __syncthreads();  // q staged / previous tile consumed
    for (int e = threadIdx.x; e < KT * HD / V; e += nthreads) {
      const int j = e / (HD / V), d0 = (e % (HD / V)) * V, pos = k0 + j;
      if (pos < s) {
        const size_t off = (((size_t)b * s + pos) * kv + kvh) * HD + d0;
        load16(k + off, k_s + j * (HD + 4) + d0, 1.f);
        load16(v + off, v_s + j * HD + d0, 1.f);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) k_s[j * (HD + 4) + d0 + u] = v_s[j * HD + d0 + u] = 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < FA_ROWS_PER_WARP; ++i) {
      const int li = warp * FA_ROWS_PER_WARP + i;
      const int r = row0 + li;
      if (r >= s || k0 > r) continue;  // warp-uniform: past the end or above the diagonal
      fold_tile<HD>(st[i], q_s + li * HD, k_s, v_s, k0 + lane <= r, scale);
    }
  }

#pragma unroll
  for (int i = 0; i < FA_ROWS_PER_WARP; ++i) {
    const int r = row0 + warp * FA_ROWS_PER_WARP + i;
    if (r >= s) continue;
    row_store<HD, T>(st[i], out + (((size_t)b * s + r) * h + head) * HD);
  }
}

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
  return bf16 ? launch<HD, __nv_bfloat16>(q, k, v, out, b, s, h, kv, scale, stream)
              : launch<HD, float>(q, k, v, out, b, s, h, kv, scale, stream);
}

}  // namespace repro_torch

// C entry point for ctypes.  bf16 selects __nv_bfloat16 (else float) for
// every tensor.  Returns the CUDA error of the attribute call or the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out, int b,
                               int s, int h, int kv, int hd, int bf16, float scale,
                               void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return dispatch_dtype<32>(bf16, q, k, v, out, b, s, h, kv, scale, st);
    case 64: return dispatch_dtype<64>(bf16, q, k, v, out, b, s, h, kv, scale, st);
    case 128: return dispatch_dtype<128>(bf16, q, k, v, out, b, s, h, kv, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
