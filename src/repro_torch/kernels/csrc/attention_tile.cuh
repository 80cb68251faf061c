// Shared pieces of the port's two attention kernels (paged chunk attention
// and causal flash attention): dtype conversion and the warp-level online
// softmax step over one staged tile of keys.
//
// Layout contract: a block stages a tile of up to KT keys in shared memory
// as float32, K as [KT][HD + 4] (the pad keeps the per-lane float4 reads of
// 32 different key rows on distinct banks) and V as [KT][HD].  Each warp
// owns whole query rows; lane j scores key j of the tile, so one tile costs
// a row one max-reduce and one sum-reduce, and the output accumulator of a
// row is spread across the warp's lanes as dims lane, lane + 32, ...
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace repro_torch {

constexpr int KT = 32;  // keys per staged tile: one per lane

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Load 16 / sizeof(X) consecutive elements from a 16-byte aligned address
// as floats times `mul` (the int8 dequant scale, else 1).
template <typename X>
__device__ __forceinline__ void load16(const X* src, float* dst, float mul) {
  constexpr int V = 16 / sizeof(X);
  alignas(16) X vals[V];
  *reinterpret_cast<uint4*>(vals) = __ldg(reinterpret_cast<const uint4*>(src));
#pragma unroll
  for (int u = 0; u < V; ++u) dst[u] = to_f32(vals[u]) * mul;
}

// Online-softmax state of one query row, held by one warp.
template <int HD>
struct RowState {
  float m;             // running max of the row's scores
  float l;             // running sum of exp(score - m)
  float acc[HD / 32];  // this lane's output dims: lane + 32 * i
};

template <int HD>
__device__ __forceinline__ void row_init(RowState<HD>& st) {
  st.m = neg_inf();
  st.l = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 32; ++i) st.acc[i] = 0.f;
}

// Fold one staged tile into a row.  `q` is the row in shared memory (float,
// 16-byte aligned), `ks`/`vs` the staged tile, `visible` whether this lane's
// key may be attended by the row.  A tile with no visible key leaves the
// state untouched, so fully masked tiles never form -inf - -inf.
template <int HD>
__device__ __forceinline__ void fold_tile(RowState<HD>& st, const float* q,
                                          const float* ks, const float* vs,
                                          bool visible, float scale) {
  const int lane = threadIdx.x & 31;
  float s = neg_inf();
  if (visible) {
    const float4* kr = reinterpret_cast<const float4*>(ks + lane * (HD + 4));
    const float4* qr = reinterpret_cast<const float4*>(q);
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < HD / 4; ++d) {
      const float4 a = qr[d];
      const float4 b = kr[d];
      dot = fmaf(a.x, b.x, dot);
      dot = fmaf(a.y, b.y, dot);
      dot = fmaf(a.z, b.z, dot);
      dot = fmaf(a.w, b.w, dot);
    }
    s = dot * scale;
  }
  float tmax = s;
#pragma unroll
  for (int o = 16; o; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
  if (tmax == neg_inf()) return;  // warp-uniform: no visible key in this tile
  const float m_new = fmaxf(st.m, tmax);
  const float alpha = expf(st.m - m_new);  // exp(-inf) = 0 on the first fold
  const float p = visible ? expf(s - m_new) : 0.f;
  float psum = p;
#pragma unroll
  for (int o = 16; o; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
  st.l = st.l * alpha + psum;
#pragma unroll
  for (int i = 0; i < HD / 32; ++i) st.acc[i] *= alpha;
#pragma unroll 8
  for (int j = 0; j < KT; ++j) {
    const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) st.acc[i] = fmaf(pj, vs[j * HD + lane + 32 * i], st.acc[i]);
  }
  st.m = m_new;
}

// Write a finished row: out[lane + 32 i] = acc / l for its first N dims (a
// row staged padded past N keeps its zero columns).  Every row the kernels
// finish has attended at least its own key, so l > 0.
template <int HD, typename T, int N = HD>
__device__ __forceinline__ void row_store(const RowState<HD>& st, T* out) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < HD / 32; ++i)
    if (N == HD || lane + 32 * i < N) out[lane + 32 * i] = from_f32<T>(st.acc[i] / st.l);
}

}  // namespace repro_torch
