// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py, ssd_scan_kernel (body
// _kernel).  Same function: for each (sequence, head) the chunks of the
// sequence are walked in order; within a chunk of Q rows
//   y[q]  = sum_{k<=q} (C_q . B_k) exp(cum_q - cum_k) dt_k x_k
//         + exp(cum_q) C_q S
//   S    <- exp(cum_{Q-1}) S + sum_k B_k dt_k exp(cum_{Q-1} - cum_k) x_k^T
// with cum the inclusive running sum of dt * A inside the chunk and S the
// [N, P] f32 state carried across chunks.  It returns y and the final S.
//
// Differences from the TPU kernel, each exact in real arithmetic:
// * The TPU kernel asserts s % chunk == 0.  Here any s >= 1 runs: the
//   ragged tail of the last chunk is padded with dt = 0 and x = 0 (decay
//   exp(0) = 1, added term 0) and no y row is written past s.
// * The TPU kernel forms exp(cum_q - cum_k) over the whole [Q, Q] tile and
//   masks it with where(); above the diagonal that exponent is positive
//   and can overflow to inf, and inf * 0 is NaN on this card.  Here the
//   weight is computed only for k <= q, where the exponent is <= 0.
// * The decays use segment sums, sum_{k<i<=q} dt_i A, summed directly, not
//   the difference of two running sums: at the model's step sizes |cum|
//   reaches the hundreds over a chunk and the difference would lose
//   |cum| * 2^-24 to cancellation (a relative error of ~1e-5 in y).
// * The result does not depend on the chunk size, so the kernel takes its
//   own row tile Q = 32 (one row per lane of a warp) whatever chunk the
//   caller names.  It computes in f32 and rounds y once.
//
// What bounds it on an H100: the bytes.  At mamba2-2.7b's prefill of
// s = 4096 (b 1, 80 heads, P 64, N 128) one layer moves ~90 MB (x and y
// 84 MB in bf16, B/C/dt/state 6 MB): ~27 us at 3.35 TB/s, against ~16
// GFLOP of useful work, ~16 us at 989 TFLOP/s.  This first design runs on
// the CUDA cores in f32, far from either floor:
// * grid: one block per (sequence, head, slice of 32 columns of P).  The
//   columns of x, y and S are independent, so slicing P needs no combine
//   and raises the grid from 80 to 160 blocks at b = 1 (132 SMs).  B and
//   C are shared by every head; each block reads them, mostly from L2.
// * per chunk: warp 0 scans dt * A with shuffles; B, C and the block's x
//   columns are staged in shared memory as f32; then three register-tiled
//   passes over shared memory (8 rows per thread, float4 broadcast reads):
//   the [Q, Q] weights G, then y = G x + exp(cum) C S, then S.  The f32
//   state stays in shared memory for the whole walk.
// Tensor cores (wgmma on the three products), TMA staging and a grid that
// splits the sequence are later work; PERF.md records the gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace repro_torch {
namespace ssd {

constexpr int Q = 32;          // rows per chunk: one per lane
constexpr int PS = 32;         // columns of P per block: one per lane
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RPT = Q / WARPS;  // rows per thread in the G and y passes

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Shared memory, in floats: B and C [Q][N + 4] (the pad keeps the per-lane
// float4 reads of 8 different rows on distinct banks), x [Q][PS],
// G [Q][Q + 4], S [N][PS], and dt * A / its running sum / dt / the state
// weights [Q] each.
template <int N>
constexpr size_t smem_floats() {
  return 2 * Q * (N + 4) + Q * PS + Q * (Q + 4) + N * PS + 4 * Q;
}

// x/y [b, s, H, P]; dt [b, s, H] f32; A [H] f32; B/C [b, s, N];
// state [b, H, N, P] f32.  grid: b * H * (P / PS) blocks.
template <int N, int P, typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ state_out, int s, int H) {
  constexpr int NS = N + 4;
  constexpr int GS = Q + 4;
  constexpr int NPT = N / WARPS;  // state rows per thread in the S pass
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;
  float* Cs = Bs + Q * NS;
  float* Xs = Cs + Q * NS;
  float* Gs = Xs + Q * PS;
  float* Ss = Gs + Q * GS;
  float* da_s = Ss + N * PS;
  float* cum_s = da_s + Q;
  float* dt_s = cum_s + Q;
  float* wk_s = dt_s + Q;

  constexpr int slices = P / PS;
  const int slice = blockIdx.x % slices;
  const int h = (blockIdx.x / slices) % H;
  const int b = blockIdx.x / (slices * H);
  const int p0 = slice * PS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float a = A[h];

  for (int e = tid; e < N * PS; e += THREADS) Ss[e] = 0.f;

  for (int t0 = 0; t0 < s; t0 += Q) {
    __syncthreads();  // the previous chunk is done with every tile
    if (warp == 0) {
      // dt, dt * A, its running sum from the chunk's start, and the sum of
      // the rows after each row (a scan of the shifted values); padded
      // rows add 0
      const int t = t0 + lane;
      const float d = t < s ? dt[((size_t)b * s + t) * H + h] : 0.f;
      const float da = d * a;
      float c = da;
      float after = __shfl_down_sync(0xffffffffu, da, 1);
      if (lane == 31) after = 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, c, o);
        if (lane >= o) c += v;
        const float w = __shfl_down_sync(0xffffffffu, after, o);
        if (lane + o < 32) after += w;
      }
      da_s[lane] = da;
      dt_s[lane] = d;
      cum_s[lane] = c;
      wk_s[lane] = d * expf(after);  // weight of row k in the new state
    }
    for (int e = tid; e < Q * N; e += THREADS) {
      const int q = e / N, n = e % N, t = t0 + q;
      float bv = 0.f, cv = 0.f;
      if (t < s) {
        const size_t off = ((size_t)b * s + t) * N + n;
        bv = to_f32(Bm[off]);
        cv = to_f32(Cm[off]);
      }
      Bs[q * NS + n] = bv;
      Cs[q * NS + n] = cv;
    }
    for (int e = tid; e < Q * PS; e += THREADS) {
      const int q = e / PS, p = e % PS, t = t0 + q;
      Xs[e] = t < s ? to_f32(x[(((size_t)b * s + t) * H + h) * P + p0 + p]) : 0.f;
    }
    __syncthreads();

    // G[q][k] = (C_q . B_k) exp(sum_{k<i<=q} dA_i) dt_k for k <= q, else 0.
    // Lane k, rows q = warp + WARPS * j.
    {
      const int k = lane;
      float seg[RPT];  // the segment sums of this thread's rows
      float run = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (q > k) run += da_s[q];
        if (q % WARPS == warp) seg[q / WARPS] = run;
      }
      float dot[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) dot[j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        const float4 bv = *reinterpret_cast<const float4*>(Bs + k * NS + n);
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const float4 cv = *reinterpret_cast<const float4*>(Cs + (warp + WARPS * j) * NS + n);
          dot[j] = fmaf(cv.x, bv.x, dot[j]);
          dot[j] = fmaf(cv.y, bv.y, dot[j]);
          dot[j] = fmaf(cv.z, bv.z, dot[j]);
          dot[j] = fmaf(cv.w, bv.w, dot[j]);
        }
      }
      const float dk = dt_s[k];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int q = warp + WARPS * j;
        // only k <= q forms the exponent, which is then <= 0
        Gs[q * GS + k] = k <= q ? dot[j] * expf(seg[j]) * dk : 0.f;
      }
    }
    __syncthreads();

    // y[q][p] = sum_k G[q][k] x[k][p] + exp(cum_q) sum_n C[q][n] S[n][p].
    // Lane p, rows q = warp + WARPS * j.
    {
      const int p = lane;
      float acc[RPT], off[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) acc[j] = off[j] = 0.f;
#pragma unroll 2
      for (int k = 0; k < Q; k += 4) {
        const float x0 = Xs[(k + 0) * PS + p], x1 = Xs[(k + 1) * PS + p];
        const float x2 = Xs[(k + 2) * PS + p], x3 = Xs[(k + 3) * PS + p];
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const float4 g = *reinterpret_cast<const float4*>(Gs + (warp + WARPS * j) * GS + k);
          acc[j] = fmaf(g.x, x0, acc[j]);
          acc[j] = fmaf(g.y, x1, acc[j]);
          acc[j] = fmaf(g.z, x2, acc[j]);
          acc[j] = fmaf(g.w, x3, acc[j]);
        }
      }
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        const float s0 = Ss[(n + 0) * PS + p], s1 = Ss[(n + 1) * PS + p];
        const float s2 = Ss[(n + 2) * PS + p], s3 = Ss[(n + 3) * PS + p];
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const float4 cv = *reinterpret_cast<const float4*>(Cs + (warp + WARPS * j) * NS + n);
          off[j] = fmaf(cv.x, s0, off[j]);
          off[j] = fmaf(cv.y, s1, off[j]);
          off[j] = fmaf(cv.z, s2, off[j]);
          off[j] = fmaf(cv.w, s3, off[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int q = warp + WARPS * j, t = t0 + q;
        if (t < s)
          y[(((size_t)b * s + t) * H + h) * P + p0 + p] =
              from_f32<T>(fmaf(expf(cum_s[q]), off[j], acc[j]));
      }
    }
    __syncthreads();  // every row has read S before it changes

    // S[n][p] = exp(cum_{Q-1}) S[n][p] + sum_k B[k][n] wk[k] x[k][p].
    // Lane p, state rows n = warp * NPT + i.
    {
      const int p = lane;
      const int n0 = warp * NPT;
      float acc[NPT];
#pragma unroll
      for (int i = 0; i < NPT; ++i) acc[i] = 0.f;
#pragma unroll 2
      for (int k = 0; k < Q; ++k) {
        const float xw = Xs[k * PS + p] * wk_s[k];
#pragma unroll
        for (int i = 0; i < NPT; i += 4) {
          const float4 bv = *reinterpret_cast<const float4*>(Bs + k * NS + n0 + i);
          acc[i + 0] = fmaf(bv.x, xw, acc[i + 0]);
          acc[i + 1] = fmaf(bv.y, xw, acc[i + 1]);
          acc[i + 2] = fmaf(bv.z, xw, acc[i + 2]);
          acc[i + 3] = fmaf(bv.w, xw, acc[i + 3]);
        }
      }
      const float decay = expf(cum_s[Q - 1]);
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        float* sp = Ss + (n0 + i) * PS + p;
        *sp = fmaf(decay, *sp, acc[i]);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < N * PS; e += THREADS) {
    const int n = e / PS, p = e % PS;
    state_out[(((size_t)b * H + h) * N + n) * P + p0 + p] = Ss[e];
  }
}

template <int N, int P, typename T>
static int launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                  void* y, void* state, int b, int s, int H, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<N>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<N, P, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<N, P, T><<<b * H * (P / PS), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y),
      static_cast<float*>(state), s, H);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int P>
static int dispatch_dtype(int bf16, const void* x, const void* dt, const void* A,
                          const void* B, const void* C, void* y, void* state, int b, int s,
                          int H, cudaStream_t stream) {
  if (bf16) return launch<N, P, __nv_bfloat16>(x, dt, A, B, C, y, state, b, s, H, stream);
  return launch<N, P, float>(x, dt, A, B, C, y, state, b, s, H, stream);
}

}  // namespace ssd
}  // namespace repro_torch

// C entry point for ctypes.  bf16 selects __nv_bfloat16 (else float) for x,
// B, C and y; dt, A and the state are float.  Every tensor is contiguous.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape it was not built for).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A, const void* B,
                        const void* C, void* y, void* state, int b, int s, int H, int P, int N,
                        int bf16, void* stream) {
  using namespace repro_torch::ssd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || s < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
#define SSD_CASE(NN, PP)                                                                    \
  if (N == NN && P == PP)                                                                   \
    return dispatch_dtype<NN, PP>(bf16, x, dt, A, B, C, y, state, b, s, H, st);
  SSD_CASE(64, 64)
  SSD_CASE(64, 128)
  SSD_CASE(128, 64)
  SSD_CASE(128, 128)
#undef SSD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
