// Cycles per wgmma of the operand layouts the port's tensor-core kernels
// use, in one warpgroup on zero tiles: REPS groups of four k16 products
// into one accumulator, chained (one commit per group, one wait at the
// end) or waited (each group waited before the next).  Built and run by
// tools/wgmma_rate.py.
#include "hopper.cuh"

using namespace repro_torch::hopper;

template <int V, bool WAIT>
__global__ void wgmma_rate(long long* out, int reps) {
  extern __shared__ uint8_t raw[];
  uint8_t* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  for (int i = threadIdx.x; i < 32768 / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(base)[i] = 0;
  fence_proxy_async();
  __syncthreads();
  float d[64];
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  const uint32_t af[4] = {0, 0, 0, 0};
  float(&d32)[32] = *reinterpret_cast<float(*)[32]>(d);
  float(&d16)[16] = *reinterpret_cast<float(*)[16]>(d);
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (V == 0)  // K-major A and B, 128 B swizzle (G = C B^T, S = Q K^T)
        wgmma_ss_n64<0, 0>(d32, kmajor_desc<128>(base, kk * 16, 64),
                           kmajor_desc<128>(base + 8192, kk * 16, 64));
      if constexpr (V == 1)  // K-major A, N-major B of two 64 B panels (hi | lo)
        wgmma_ss_n64<0, 1>(d32, kmajor_desc<128>(base, kk * 16, 64),
                           nmajor_desc<64>(base + 16384, kk * 16, 64));
      if constexpr (V == 2)  // M-major A (B read transposed), N-major B (u = B^T (w o x))
        wgmma_ss_n64<1, 1>(d32, nmajor_desc<128>(base, kk * 16, 64),
                           nmajor_desc<64>(base + 16384, kk * 16, 64));
      if constexpr (V == 3)  // K-major A, N-major B of one 64 B panel (y2 = C S)
        wgmma_ss_n32<0, 1>(d16, kmajor_desc<128>(base, kk * 16, 64),
                           nmajor_desc<64>(base + 16384, kk * 16, 64));
      if constexpr (V == 4)  // register A, N-major B (y = W x)
        wgmma_rs_n32<1>(d16, af, nmajor_desc<64>(base + 16384, kk * 16, 64));
      if constexpr (V == 5)  // register A, N-major B of two 128 B panels (O += P V)
        wgmma_rs_n128<1>(d, af, nmajor_desc<128>(base + 16384, kk * 16, 64));
    }
    wgmma_commit();
    if (WAIT) wgmma_wait<0>();
  }
  wgmma_wait<0>();
  fence_regs(d);
  const long long t1 = clock64();
  float sum = 0.f;
  for (int i = 0; i < 64; ++i) sum += d[i];
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = static_cast<long long>(sum);
  }
}

template <int V, bool WAIT>
static int run(long long* out, int reps) {
  constexpr int smem = 48 * 1024;
  cudaFuncSetAttribute(wgmma_rate<V, WAIT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  wgmma_rate<V, WAIT><<<1, 128, smem>>>(out, reps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgmma_rate(int variant, int wait, long long* out, int reps) {
#define V(N) \
  if (variant == N) return wait ? run<N, true>(out, reps) : run<N, false>(out, reps);
  V(0) V(1) V(2) V(3) V(4) V(5)
#undef V
  return -1;
}
