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
// * The decays that the f32 tolerance rests on use segment sums,
//   sum_{k<i<=q} dt_i A, summed directly, not the difference of two
//   running sums: at the model's step sizes |cum| reaches the hundreds
//   over a chunk and the difference would lose |cum| * 2^-24 to
//   cancellation (a relative error of ~1e-5).  The f32 kernel does so for
//   every decay, the bf16 one for the state's (y is bf16 there).
// * The result does not depend on the chunk size, so each kernel takes its
//   own row tile whatever chunk the caller names.  Both compute in f32 (the
//   bf16 one with f32 operands split into bf16 terms) and round y once.
//
// What bounds it on an H100: the bytes.  At mamba2-2.7b's prefill of
// s = 4096 (b 1, 80 heads, P 64, N 128) one layer moves ~90 MB (x and y
// 84 MB in bf16, B/C/dt/state 6 MB): ~27 us at 3.35 TB/s, against ~16
// GFLOP of useful work, ~16 us at 989 TFLOP/s.
//
// bf16 (ssd_scan_tc_kernel): the tensor cores.  One block per (sequence,
// head, slice of 32 columns of P): the columns of x, y and S are
// independent, so slicing P needs no combine, keeps the bytes at the floor
// and gives 160 blocks at b = 1 (132 SMs; two fit an SM).  Row tile Q = 64
// (wgmma's M).  B, C and x arrive through a two-stage ring of TMA loads
// tracked by mbarriers.  The block's two warpgroups split each chunk into
// its two independent halves and run them side by side, the state path up
// to a chunk ahead, handing over through mbarriers:
// * the state path: dt A scanned into running sums (for the decays) and
//   direct suffix sums (for the state's weights w, which carry the f32
//   tolerance); then u = B^T (w o x), with B read M-major from its staged
//   tile as the A operand and w o x split into kWxTerms bf16 tiles
//   ((B o w)^T x = B^T (w o x): the split operand is a [Q, 32] tile written
//   with 16-byte stores); then S <- exp(cum_{Q-1}) S + u with one fma per
//   element, the f32 state in registers for the whole walk; then S split
//   into kSTerms bf16 tiles for the next chunk.  The hi and lo tiles of a
//   split operand are two panels of one 64-column B operand, so one m64n64
//   wgmma sums both terms; w o x's third tile is a 32-column B operand
//   whose m64n32 products accumulate into the hi columns (an m64n32
//   fragment is the first half of an m64n64 one), so it costs no
//   registers.
// * the y path: y2 = C S (the state entering the chunk, from its tiles) and
//   G = C B^T [Q, Q] (m64n64k16, exact bf16 products, f32 sums); W = G o
//   exp2(cum2_q - cum2_k) o dt_k for k <= q on G's fragment (cum2 the
//   running sum in base 2); y = W x with W split into kWTerms register A
//   operands; y += exp(cum_q) y2.  B and C are shared by all heads; every
//   block recomputes G rather than reading it from a pre-pass: it is a
//   fifth of the block's tensor-core work, and a pre-pass would cost a
//   second launch and a [b, chunks, Q, Q] f32 round trip.
// Term counts: the smallest that meet the f32-grade tolerance with margin
// at the main paths' magnitudes (tests/test_torch_tc_numerics.py); one term
// misses it for each of W, S and w o x.  The state takes a third term of
// w o x: with two it carries ~3e-6 of its own magnitude (every chunk's
// update off by the lo term's rounding), which passes the tolerance's 2e-5
// only while a state element stays under ~7 (tools/k4_state_error.py; a
// draw at b 1, s 2048, N 64 missed at 2.48e-5); with three, ~1e-7.  The in-chunk decays are
// differences of running sums: their cancellation (|cum| 2^-24 in the
// exponent) is far inside y's bf16 tolerance.
// Left for later: the chunk-parallel form (intra-chunk outputs and chunk
// states in parallel, then the state recurrence), which fills the card at
// b = 1 with more blocks but moves nc H N P 4 bytes of chunk states (84 MB
// at s = 4096, doubling the byte floor); a producer warp; sharing G between
// the heads of one SM.
//
// float32 (ssd_scan_kernel): the CUDA cores in f32, row tile 32, one block
// per (sequence, head, 32 columns of P) as above; per chunk warp 0 scans
// dt * A with shuffles, B, C and x are staged in shared memory as f32, and
// three register-tiled passes form G, y and S, the state in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "hopper.cuh"

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

}  // namespace ssd

namespace ssd_tc {
using namespace hopper;

constexpr int Q = 64;          // rows per chunk: wgmma's M
constexpr int PS = 32;         // columns of P per block
constexpr int THREADS = 256;   // two warpgroups: the y path and the state path
constexpr int STAGES = 2;      // ring of B, C and x tiles
constexpr int kWTerms = 2;     // bf16 terms of W in y = W x
constexpr int kSTerms = 2;     // bf16 terms of S in y += exp(cum) C S
constexpr int kWxTerms = 3;    // bf16 terms of w o x in the state update
constexpr float LOG2E = 1.4426950408889634f;

template <int N>
struct Shape {
  static constexpr int CB = Q * N * 2;    // bytes of a C or B tile (128 B panels)
  static constexpr int XT = Q * PS * 2;   // bytes of an x or w o x tile (64 B rows)
  static constexpr int STAGE = 2 * CB + XT;
  static constexpr int ST = N * PS * 2;   // bytes of one S term tile (64 B rows)
  // alignment slack, the ring, S hi/lo, (w o x) hi/lo/lo2, two sets of
  // three [Q] f32 vectors for the y path and one for the state path,
  // mbarriers
  static constexpr size_t SMEM =
      1024 + STAGES * STAGE + 2 * ST + 3 * XT + 7 * Q * 4 + 8 * (3 * STAGES + 2);
};

// dt [b, s, H] f32, A [H] f32; the maps cover x [b, s, H, P] and B, C
// [b, s, N] (bf16); y [b, s, H, P] bf16; state [b, H, N, P] f32.
// grid: b * H * (P / PS) blocks of 256 threads.
template <int N, int P>
__global__ void __launch_bounds__(THREADS, 2)
ssd_scan_tc_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap b_map,
                   const __grid_constant__ CUtensorMap c_map, const float* __restrict__ dt,
                   const float* __restrict__ A, __nv_bfloat16* __restrict__ y,
                   float* __restrict__ state_out, int s, int H) {
  using Sh = Shape<N>;
  constexpr int HALVES = N / 64;  // state rows in m64 halves
  constexpr int slices = P / PS;
  static_assert(kWTerms == 2 && kSTerms == 2 && kWxTerms == 3,
                "W and S issue a hi and a lo term, w o x a third as well");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* s_hi = base + STAGES * Sh::STAGE;  // S entering the chunk, hi and lo
  uint8_t* s_lo = s_hi + Sh::ST;              // panels (one N-major B operand)
  uint8_t* wx_hi = s_lo + Sh::ST;             // w o x, hi and lo panels
  uint8_t* wx_lo = wx_hi + Sh::XT;
  uint8_t* wx_lo2 = wx_lo + Sh::XT;           // and its third term
  // per chunk parity: [2][Q] running sums of dt A in base 2, their exp, dt
  float* cum2_s = reinterpret_cast<float*>(wx_lo2 + Sh::XT);
  float* ecum_s = cum2_s + 2 * Q;
  float* dt_s = ecum_s + 2 * Q;
  float* wk_s = dt_s + 2 * Q;  // [Q] the state weights w
  uint64_t* full = reinterpret_cast<uint64_t*>(wk_s + Q);  // [STAGES] TMA landed
  uint64_t* empty = full + STAGES;     // [STAGES] both paths done with a stage
  uint64_t* sc_ready = empty + STAGES;  // [2] a chunk's scalars written
  uint64_t* s_ready = sc_ready + 2;    // the S tiles of the next chunk written
  uint64_t* s_read = s_ready + 1;      // the y path done reading them

  const int slice = blockIdx.x % slices;
  const int h = (blockIdx.x / slices) % H;
  const int b = blockIdx.x / (slices * H);
  const int p0 = slice * PS;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wt = tid & 127;  // thread in its warpgroup
  const int warp = wt >> 5, lane = tid & 31;
  const int r_lo = warp * 16 + (lane >> 2);  // fragment rows r_lo, r_lo + 8
  const int nc = (s + Q - 1) / Q;

  auto c_t = [&](int st) { return base + st * Sh::STAGE; };
  auto b_t = [&](int st) { return base + st * Sh::STAGE + Sh::CB; };
  auto x_t = [&](int st) { return base + st * Sh::STAGE + 2 * Sh::CB; };
  auto load_chunk = [&](int st, int c) {
    mbar_expect_tx(&full[st], Sh::STAGE);
#pragma unroll
    for (int p = 0; p < N / 64; ++p) {
      tma_load_3d(c_t(st) + p * Q * 128, &c_map, &full[st], p * 64, c * Q, b);
      tma_load_3d(b_t(st) + p * Q * 128, &b_map, &full[st], p * 64, c * Q, b);
    }
    tma_load_4d(x_t(st), &x_map, &full[st], p0, h, c * Q, b);
  };

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], THREADS);
      mbar_init(&sc_ready[i], 128);
    }
    mbar_init(s_ready, 128);
    mbar_init(s_read, 128);
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- the y path: y = W x + exp(cum) C S per chunk ----------------------
    if (tid == 0)
      for (int c = 0; c < STAGES && c < nc; ++c) load_chunk(c, c);
    for (int c = 0; c < nc; ++c) {
      const int st = c % STAGES;
      const int sb = c & 1;
      // G = C B^T; the state's part of y, y2 = C (S_hi + S_lo), comes last
      // so that the y path waits for the state path as late as it can
      float g[32], y2[16], yc[16];
#pragma unroll
      for (int i = 0; i < 32; ++i) g[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) y2[i] = yc[i] = 0.f;
      mbar_wait(&full[st], (c / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_ss_n64<0, 0>(g, kmajor_desc<128>(c_t(st), kk * 16, Q),
                           kmajor_desc<128>(b_t(st), kk * 16, Q));
      wgmma_commit();
      mbar_wait(&sc_ready[sb], (c >> 1) & 1);
      wgmma_wait<0>();
      fence_regs(g);

      // W on G's fragment (row q, column k), then y = W x
      const float* cum2 = cum2_s + sb * Q;
      const float* dts = dt_s + sb * Q;
      uint32_t w_hi[16], w_lo[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int q = r_lo + 8 * ((i >> 1) & 1);
        const int k = (i / 4) * 8 + (lane & 3) * 2;
        const float cq = cum2[q];
        const float2 ck = *reinterpret_cast<const float2*>(cum2 + k);
        const float2 dk = *reinterpret_cast<const float2*>(dts + k);
        // only k <= q forms the exponent, which is then <= 0
        const float w0 = k <= q ? g[i] * exp2f(cq - ck.x) * dk.x : 0.f;
        const float w1 = k + 1 <= q ? g[i + 1] * exp2f(cq - ck.y) * dk.y : 0.f;
        split_pack(w0, w1, w_hi[i / 2], w_lo[i / 2]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dx = nmajor_desc<64>(x_t(st), kk * 16, Q);
        const uint32_t ah[4] = {w_hi[4 * kk], w_hi[4 * kk + 1], w_hi[4 * kk + 2],
                                w_hi[4 * kk + 3]};
        const uint32_t al[4] = {w_lo[4 * kk], w_lo[4 * kk + 1], w_lo[4 * kk + 2],
                                w_lo[4 * kk + 3]};
        wgmma_rs_n32<1>(yc, ah, dx);
        wgmma_rs_n32<1>(yc, al, dx);
      }
      wgmma_commit();
      mbar_wait(s_ready, c & 1);  // S entering chunk c
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint64_t dc = kmajor_desc<128>(c_t(st), kk * 16, Q);
        wgmma_ss_n32<0, 1>(y2, dc, nmajor_desc<64>(s_hi, kk * 16, N));
        wgmma_ss_n32<0, 1>(y2, dc, nmajor_desc<64>(s_lo, kk * 16, N));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(yc);
      fence_regs(y2);
      mbar_arrive(s_read);  // the state path may overwrite the S tiles
      mbar_arrive(&empty[st]);
      const float* ecum = ecum_s + sb * Q;
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int q = r_lo + 8 * ((i >> 1) & 1);
        const int t = c * Q + q;
        if (t >= s) continue;
        const int p = (i / 4) * 8 + (lane & 3) * 2;
        const float e = ecum[q];
        *reinterpret_cast<__nv_bfloat162*>(y + (((size_t)b * s + t) * H + h) * P + p0 + p) =
            __floats2bfloat162_rn(fmaf(e, y2[i], yc[i]), fmaf(e, y2[i + 1], yc[i + 1]));
      }
      if (tid == 0 && c + STAGES < nc) {
        mbar_wait(&empty[st], (c / STAGES) & 1);
        load_chunk(st, c + STAGES);
      }
    }
  } else {
    // ---- the state path: S <- exp(cum_{Q-1}) S + B^T (w o x) --------------
    const float a = A[h];
    float d_lo = 0.f, d_hi = 0.f;  // warp 0 of the path: dt of the next chunk
    if (warp == 0) {
      if (lane < s) d_lo = dt[((size_t)b * s + lane) * H + h];
      if (lane + 32 < s) d_hi = dt[((size_t)b * s + lane + 32) * H + h];
    }
    float S[HALVES][16];  // the f32 state: m64n32 fragments of rows 64 hf ..
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
      for (int i = 0; i < 16; ++i) S[hf][i] = 0.f;
    auto write_s_tiles = [&]() {  // S split into bf16 tiles [N][PS]
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
        for (int i = 0; i < 16; i += 2) {
          const int n = hf * 64 + r_lo + 8 * ((i >> 1) & 1);
          const int p = (i / 4) * 8 + (lane & 3) * 2;
          uint32_t hi, lo;
          split_pack(S[hf][i], S[hf][i + 1], hi, lo);
          const uint32_t off = swizzled_offset<64>(n, p, N);
          *reinterpret_cast<uint32_t*>(s_hi + off) = hi;
          *reinterpret_cast<uint32_t*>(s_lo + off) = lo;
        }
      fence_proxy_async();
      mbar_arrive(s_ready);
    };
    write_s_tiles();  // S entering chunk 0
    for (int c = 0; c < nc; ++c) {
      const int st = c % STAGES;
      const int sb = c & 1;
      if (warp == 0) {
        // running sums of dt A from the chunk's start (rows lane, lane + 32)
        // and the sums of the rows after each row, each summed directly
        const float da_lo = d_lo * a, da_hi = d_hi * a;
        float c_lo = da_lo, c_hi = da_hi;
        float n_lo = __shfl_down_sync(0xffffffffu, da_lo, 1);
        float n_hi = __shfl_down_sync(0xffffffffu, da_hi, 1);
        if (lane == 31) n_lo = n_hi = 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u_lo = __shfl_up_sync(0xffffffffu, c_lo, o);
          const float u_hi = __shfl_up_sync(0xffffffffu, c_hi, o);
          const float w_lo = __shfl_down_sync(0xffffffffu, n_lo, o);
          const float w_hi = __shfl_down_sync(0xffffffffu, n_hi, o);
          if (lane >= o) { c_lo += u_lo; c_hi += u_hi; }
          if (lane + o < 32) { n_lo += w_lo; n_hi += w_hi; }
        }
        const float tot_lo = __shfl_sync(0xffffffffu, c_lo, 31);
        const float tot_hi = __shfl_sync(0xffffffffu, c_hi, 31);
        c_hi += tot_lo;
        float* cum2 = cum2_s + sb * Q;
        float* ecum = ecum_s + sb * Q;
        float* dts = dt_s + sb * Q;
        cum2[lane] = c_lo * LOG2E;
        cum2[lane + 32] = c_hi * LOG2E;
        ecum[lane] = expf(c_lo);
        ecum[lane + 32] = expf(c_hi);
        dts[lane] = d_lo;
        dts[lane + 32] = d_hi;
        wk_s[lane] = d_lo * expf(n_lo + tot_hi);
        wk_s[lane + 32] = d_hi * expf(n_hi);
        // the next chunk's dt, in flight while this chunk computes
        const int t = c * Q + Q + lane;
        d_lo = t < s ? dt[((size_t)b * s + t) * H + h] : 0.f;
        d_hi = t + 32 < s ? dt[((size_t)b * s + t + 32) * H + h] : 0.f;
      }
      named_sync(1, 128);  // the chunk's scalars
      mbar_arrive(&sc_ready[sb]);
      mbar_wait(&full[st], (c / STAGES) & 1);
      {
        // w o x split into three bf16 tiles shaped as x: thread -> row
        // wt / 2, 16 columns (two 16-byte chunks)
        const int k = wt >> 1;
        const float w = wk_s[k];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t off = swizzled_offset<64>(k, (wt & 1) * 16 + j * 8, Q);
          const uint4 xv = *reinterpret_cast<const uint4*>(x_t(st) + off);
          const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
          uint4 hv, lv, l2v;
          uint32_t* hp = reinterpret_cast<uint32_t*>(&hv);
          uint32_t* lp = reinterpret_cast<uint32_t*>(&lv);
          uint32_t* l2p = reinterpret_cast<uint32_t*>(&l2v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(xp[e]);
            const float a = w * f.x, c = w * f.y;
            split_pack(a, c, hp[e], lp[e]);
            // the third term: what hi and lo leave, rounded once more
            const float2 hf = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&hp[e]));
            const float2 lf = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&lp[e]));
            const __nv_bfloat162 r =
                __floats2bfloat162_rn((a - hf.x) - lf.x, (c - hf.y) - lf.y);
            l2p[e] = *reinterpret_cast<const uint32_t*>(&r);
          }
          *reinterpret_cast<uint4*>(wx_hi + off) = hv;
          *reinterpret_cast<uint4*>(wx_lo + off) = lv;
          *reinterpret_cast<uint4*>(wx_lo2 + off) = l2v;
        }
      }
      fence_proxy_async();
      named_sync(1, 128);  // the w o x tiles
      // u = B^T (w o x), B read M-major as the A operand; w o x hi and lo
      // are the two 32-column panels of one 64-column B operand, so one
      // m64n64 product gives both terms' sums (columns 0-31 and 32-63); the
      // third term's m64n32 products add into columns 0-31
      const float decay = ecum_s[sb * Q + Q - 1];
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) {
        float u[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) u[i] = 0.f;
        float (&u_hi)[16] = *reinterpret_cast<float (*)[16]>(u);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t bt = nmajor_desc<128>(b_t(st) + hf * Q * 128, kk * 16, Q);
          wgmma_ss_n64<1, 1>(u, bt, nmajor_desc<64>(wx_hi, kk * 16, Q));
          wgmma_ss_n32<1, 1>(u_hi, bt, nmajor_desc<64>(wx_lo2, kk * 16, Q));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(u);
#pragma unroll
        for (int i = 0; i < 16; ++i) S[hf][i] = fmaf(decay, S[hf][i], u[i] + u[i + 16]);
      }
      mbar_arrive(&empty[st]);
      mbar_wait(s_read, c & 1);  // the y path has read S entering chunk c
      write_s_tiles();           // S entering chunk c + 1
    }
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int n = hf * 64 + r_lo + 8 * ((i >> 1) & 1);
        const int p = (i / 4) * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(state_out + (((size_t)b * H + h) * N + n) * P + p0 + p) =
            make_float2(S[hf][i], S[hf][i + 1]);
      }
  }
}

template <int N, int P>
static int launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                  void* y, void* state, int b, int s, int H, cudaStream_t stream) {
  using Sh = Shape<N>;
  CUtensorMap x_map, b_map, c_map;
  const uint64_t xd[4] = {P, (uint64_t)H, (uint64_t)s, (uint64_t)b};
  const uint32_t xbox[4] = {PS, 1, Q, 1};
  const uint64_t bd[3] = {N, (uint64_t)s, (uint64_t)b};
  const uint32_t bbox[3] = {64, Q, 1};
  int err = make_tensor_map(&x_map, x, 4, xd, xbox, 64);
  if (!err) err = make_tensor_map(&b_map, B, 3, bd, bbox, 128);
  if (!err) err = make_tensor_map(&c_map, C, 3, bd, bbox, 128);
  if (err) return err;
  const cudaError_t attr = cudaFuncSetAttribute(ssd_scan_tc_kernel<N, P>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(Sh::SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  ssd_scan_tc_kernel<N, P><<<b * H * (P / PS), THREADS, Sh::SMEM, stream>>>(
      x_map, b_map, c_map, static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(state), s, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssd_tc

template <int N, int P>
static int dispatch_dtype(int bf16, const void* x, const void* dt, const void* A,
                          const void* B, const void* C, void* y, void* state, int b, int s,
                          int H, cudaStream_t stream) {
  if (bf16) return ssd_tc::launch<N, P>(x, dt, A, B, C, y, state, b, s, H, stream);
  return ssd::launch<N, P, float>(x, dt, A, B, C, y, state, b, s, H, stream);
}

}  // namespace repro_torch

// C entry point for ctypes.  bf16 selects __nv_bfloat16 and the tensor-core
// kernel (else float and the CUDA-core one) for x, B, C and y; dt, A and the
// state are float.  Every tensor is contiguous.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape it was not built for).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A, const void* B,
                        const void* C, void* y, void* state, int b, int s, int H, int P, int N,
                        int bf16, void* stream) {
  using namespace repro_torch;
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
