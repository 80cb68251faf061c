// Hopper (sm_90a) building blocks of the port's tensor-core kernels, in
// inline PTX: the warpgroup matrix multiply (wgmma) with its shared-memory
// matrix descriptors and fences, the warp-level mma.sync with ldmatrix and
// cp.async copies, mbarriers, TMA tile loads with the tensor map built on
// the host, and the split of an f32 value into bf16 terms.
//
// Layout contract.  A tile that wgmma reads from shared memory is stored as
// TMA's swizzled layout writes it: rows of SW bytes (SW = 128 or 64, the
// swizzle span), 16-byte chunks of row r XOR-ed with (r % 8) for 128 B or
// ((r / 2) % 4) for 64 B, and a tile whose rows are wider than SW stored as
// consecutive panels of SW / 2 bf16 columns each.  Every panel starts on a
// 1024-byte boundary.  `swizzled_offset` gives the byte of one element, for
// threads that write such a tile themselves or read it element-wise.
//
// Fragment layouts of a warpgroup's m64nN accumulator (f32, N / 2 registers
// per thread; warp w, lane l): register i holds row 16 w + l / 4 + 8 ((i / 2)
// % 2) and column 8 (i / 4) + 2 (l % 4) + i % 2.  A register A operand of
// one k16 step packs, as bf16x2, (row r0, cols k0, k0 + 1), (r0 + 8, k0,
// k0 + 1), (r0, k0 + 8, k0 + 9), (r0 + 8, k0 + 8, k0 + 9), with r0 = 16 w +
// l / 4 and k0 = 2 (l % 4): the accumulator registers 8 j .. 8 j + 7 of an
// m64n64 product are, in order, the A operand of its k16 step j.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace repro_torch {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// bf16 splits
// ---------------------------------------------------------------------------

// v = hi + lo + O(2^-16 |v|): hi = bf16(v), lo = bf16(v - hi), each rounded
// to nearest even.  Two values (the lower column first) per bf16x2 register.
__device__ __forceinline__ void split_pack(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - f.x, b - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---------------------------------------------------------------------------
// swizzled shared-memory tiles and wgmma descriptors
// ---------------------------------------------------------------------------

// Byte offset of element (row, col) of a bf16 tile of `rows` rows stored in
// panels of SW bytes (see the layout contract above).
template <int SW>
__device__ __forceinline__ uint32_t swizzled_offset(int row, int col, int rows) {
  constexpr int PE = SW / 2;  // bf16 per panel row
  const int panel = col / PE, c = col % PE;
  const int chunk = (c * 2) / 16;
  const int sw = SW == 128 ? (row & 7) : ((row >> 1) & 3);
  return panel * rows * SW + row * SW + ((chunk ^ sw) * 16) + (c * 2) % 16;
}

template <int SW>
__host__ __device__ constexpr uint64_t layout_bits() {
  return SW == 128 ? 1ull : (SW == 64 ? 2ull : 3ull);
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (LBO, SBO) and the swizzle mode.  K-major swizzled operands ignore
// LBO; for them SBO is the stride between 8-row groups (8 SW).  N-major
// (transposed) operands: LBO is the stride between panels, SBO between
// groups of 8 rows along K.
template <int SW>
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= layout_bits<SW>() << 62;
  return d;
}

// Descriptor of the 16-column k step starting at column `k0` of a K-major
// tile of `rows` rows (in SW-byte panels).
template <int SW>
__device__ __forceinline__ uint64_t kmajor_desc(const void* tile, int k0, int rows) {
  constexpr int PE = SW / 2;
  const char* p = static_cast<const char*>(tile) + (k0 / PE) * rows * SW + (k0 % PE) * 2;
  return make_desc<SW>(p, 16, 8 * SW);
}

// Descriptor of the 16-row k step starting at row `k0` of an N-major (or,
// as an A operand, M-major) tile of `rows` rows, the N columns in SW-byte
// panels.
template <int SW>
__device__ __forceinline__ uint64_t nmajor_desc(const void* tile, int k0, int rows) {
  const char* p = static_cast<const char*>(tile) + k0 * SW;
  return make_desc<SW>(p, rows * SW, 8 * SW);
}

// ---------------------------------------------------------------------------
// wgmma: fences and the products
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Orders this thread's generic shared-memory writes before wgmma (the async
// proxy) reads them; a barrier across the warpgroup must follow.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D[64 x 32] += A[64 x 16] B[16 x 32] in f32; A and B from shared memory
// (TRANS_A = 1: A stored M-major; TRANS_B = 1: B stored N-major).
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

// D[64 x 64] += A[64 x 16] B[16 x 64] in f32; A and B from shared memory
// (TRANS_A = 1: A stored M-major; TRANS_B = 1: B stored N-major).
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

// D[64 x 32] += A[64 x 16] B[16 x 32] in f32; A from registers, B from
// shared memory (TRANS_B = 1: B stored N-major).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
          "n"(TRANS_B));
}

// D[64 x 64] += A[64 x 16] B[16 x 64] in f32; A from registers, B from
// shared memory (TRANS_B = 1: B stored N-major).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
          "n"(TRANS_B));
}

// D[64 x 128] += A[64 x 16] B[16 x 128] in f32; A from registers, B from
// shared memory (TRANS_B = 1: B stored N-major).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
          "n"(TRANS_B));
}

// ---------------------------------------------------------------------------
// warp-level products (mma.sync), ldmatrix and cp.async
// ---------------------------------------------------------------------------

// D[16 x 8] += A[16 x 16] B[16 x 8], bf16 operands, f32 sums.  Fragments
// (lane l, r = l / 4, c = 2 (l % 4)): a[0] = A(r, c..c+1), a[1] = A(r + 8,
// c..), a[2] = A(r, c + 8..), a[3] = A(r + 8, c + 8..); b0 = B(c..c+1, r),
// b1 = B(c + 8.., r); d[0..1] = D(r, c..c+1), d[2..3] = D(r + 8, c..c+1).
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8 j .. 8 j + 7 give
// the row addresses of matrix j, and register j of lane l holds row l / 4,
// columns 2 (l % 4) .. + 1 of matrix j (of its transpose with kTrans).
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  if constexpr (kTrans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(row)));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(row)));
  }
}

// A 16-byte copy from global to shared memory that bypasses L1; with
// `valid` false it writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's newest copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two int8 values (the lower address first) as a bf16x2 register: exact.
__device__ __forceinline__ uint32_t int8x2_bf16x2(int8_t lo, int8_t hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo), static_cast<float>(hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` of TMA traffic before the phase ends.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// One arrival of this thread (release: its prior writes are visible to the
// threads that wait on the phase).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Barrier `id` (1-15) over `n` threads: the warps of one warpgroup.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// Wait until the phase of parity `parity` (0 for the first use) completes.
// A load that never lands traps the kernel after ~2 s (a launch error for
// the caller) instead of spinning forever.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    if (clock64() - start > (4ll << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA loads of one box into shared memory, completing on `bar`.  Elements
// outside the tensor are filled with zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Host: a tensor map over a contiguous bf16 tensor of `rank` dims (sizes
// innermost first), a box of `box` elements, swizzled by SW bytes.
// Returns 0 or a CUDA error code.  The driver's encoder is looked up
// through the runtime, so the library links against nothing but cudart.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline int make_tensor_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
                           const uint32_t* box, int sw_bytes) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  cuuint64_t size[5], stride[4];
  cuuint32_t boxd[5], estride[5];
  uint64_t bytes = sizeof(__nv_bfloat16);
  for (int i = 0; i < rank; ++i) {
    size[i] = dims[i];
    boxd[i] = box[i];
    estride[i] = 1;
    if (i > 0) stride[i - 1] = bytes;
    bytes *= dims[i];
  }
  const CUtensorMapSwizzle sw = sw_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : sw_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
                            size, stride, boxd, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hopper
}  // namespace repro_torch
