#!/usr/bin/env python3
"""Where the time of the bf16 paged-attention walk (K1 and K3) goes, on the card.

Run from the repository root on a machine with one CUDA card:

    python3 tools/k1_profile.py

It copies ``paged_chunk_attention.cu`` and patches ``paged_tc_kernel``:
thread 0 of every block reads the global timer (ns) at the kernel's phase
boundaries, and thread 0 of the first block counts clock64() cycles per key
tile spent waiting for the tile, issuing the next copies and folding.  It
builds the copy with the port's nvcc flags under ``build/k1_profile/`` and
runs K1 at the dense path's decode (also with every length 0: the fixed
cost), verify and suffix-prefill shapes and K3 at the decode shape
(qwen2-1.5b widths, bf16, the splits the wrapper picks).  For each it
prints the kernel's cold-L2 time, the per-tile cycles, how long after the
first block the last one started and ended, and the mean time of each
phase per block, cold and warm L2; and, at decode, how many blocks and
clusters the card holds at once.  An anchor missing from the source fails
the run.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.paged_attention import ops  # noqa: E402

MAX_BLOCKS = 4096
STAMPS = 8
MARKS = [
    ("  cluster.sync();\n  const int real_rows", 7),
    ("    group_sync();                         // ... everyone's; tile i - 1 consumed\n", 6),
    ("  extern __shared__ __align__(128) uint8_t smem[];\n  cg::cluster_group", 0),
    ("  __syncthreads();  // pages resolved\n", 1),
    ("  __syncthreads();  // the ring is free\n", 2),
    ("  // the cluster's partials: every rank", 3),
    ('  asm volatile("barrier.cluster.arrive.relaxed.aligned;', 4),
]
NAMES = ["resolve pages, load q", "walk the key tiles", "write and merge partials",
         "cluster barrier + merge", "final cluster barrier"]


def patched_source() -> str:
    src = (ROOT / "src/repro_torch/kernels/paged_attention/csrc/"
           "paged_chunk_attention.cu").read_text()
    for anchor, i in MARKS:
        if src.count(anchor) != 1:
            sys.exit(f"anchor not found once: {anchor!r}")
        stamp = f"  STAMP({i});\n"
        if i == 0:
            head, tail = anchor.split("\n", 1)
            src = src.replace(anchor, head + "\n" + stamp + tail)
        elif i == 3:
            src = src.replace(anchor, stamp + anchor)
        elif i == 7:
            src = src.replace(anchor, "  cluster.sync();\n  STAMP(7);\n  const int real_rows")
        elif i == 6:
            src = src.replace(anchor, anchor + "    if (i == 0) STAMP(6);\n")
        elif i == 4:
            tail = '                   "memory");\n}\n'
            at = src.index(anchor)
            end = src.index(tail, at) + len(tail)
            src = (src[:at] + "  STAMP(4);\n" + src[at:end - 2] + "  STAMP(5);\n}\n"
                   + src[end:])
        else:
            src = src.replace(anchor, anchor + stamp)
    src = src.replace(
        '#include "hopper.cuh"\n',
        '#include "hopper.cuh"\n'
        f"__device__ unsigned long long g_stamp[{MAX_BLOCKS}][{STAMPS}];\n"
        "__device__ long long g_prof[8];\n"
        "#define PROF(i) do { if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && "
        "threadIdx.x == 0) { long long n_ = clock64(); g_prof[i] += n_ - t_; t_ = n_; } } while (0)\n"
        "#define STAMP(i) do { if (threadIdx.x == 0) { unsigned long long n_; "
        'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(n_)); '
        "const unsigned blk_ = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z); "
        f"if (blk_ < {MAX_BLOCKS}) g_stamp[blk_][i] = n_; }} }} while (0)\n", 1)
    loop = ("    group_sync();                         // ... everyone's; tile i - 1 consumed\n",
            "    hopper::cp_async_commit();\n    if (active) fold(i);\n  }\n")
    for anchor in loop:
        if src.count(anchor) != 1:
            sys.exit(f"anchor not found once: {anchor!r}")
    src = src.replace(loop[0], loop[0] + "    PROF(0);\n")
    src = src.replace(loop[1], "    hopper::cp_async_commit();\n    PROF(1);\n    if (active) fold(i);\n"
                      "    if (st.o[0][0] == 1.2345e-30f && st.l[0] == 1.2345e-30f) g_prof[7] += 1;\n"
                      "    PROF(2);\n  }\n")
    src = src.replace("  for (int i = 0; i < count; ++i) {\n    hopper::cp_async_wait<STAGES - 2>();",
                      "  long long t_ = clock64();\n  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x == 0) g_prof[3] += count;\n"
                      "  for (int i = 0; i < count; ++i) {\n    hopper::cp_async_wait<STAGES - 2>();")
    src += ('\nextern "C" int read_stamps(unsigned long long* out) { return (int)'
            "cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp)); }\n"
            'extern "C" int read_prof(long long* out) { return (int)'
            "cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * 8); }\n"
            'extern "C" int zero_prof() { long long z[8] = {0}; return (int)'
            "cudaMemcpyToSymbol(g_prof, z, sizeof z); }\n"
            # blocks per SM and clusters of n_split the card holds at once
            'extern "C" int occupancy(int warp_keys, int n_split, int smem, int* blocks, '
            "int* clusters) {\n"
            "  using namespace repro_torch;\n"
            "  auto k = warp_keys ? paged_tc_kernel<128, __nv_bfloat16, true, true>\n"
            "                     : paged_tc_kernel<128, __nv_bfloat16, true, false>;\n"
            "  const int nth = warp_keys ? 32 : 32 * TC_WARPS;\n"
            "  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, "
            "nth, smem);\n"
            "  if (e) return (int)e;\n"
            "  cudaLaunchConfig_t cfg = {}; cfg.gridDim = dim3(64, 1, n_split);\n"
            "  cfg.blockDim = dim3(nth); cfg.dynamicSmemBytes = smem;\n"
            "  cudaLaunchAttribute a[1]; a[0].id = cudaLaunchAttributeClusterDimension;\n"
            "  a[0].val.clusterDim.x = 1; a[0].val.clusterDim.y = 1; a[0].val.clusterDim.z = n_split;\n"
            "  cfg.attrs = a; cfg.numAttrs = 1;\n"
            "  return (int)cudaOccupancyMaxActiveClusters(clusters, k, &cfg);\n}\n")
    return src


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    out = ROOT / "build" / "k1_profile"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "paged_profile.cu", out / "paged_profile.so"
    cu.write_text(patched_source())
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                       capture_output=True, text=True)
    if r.returncode:
        sys.exit(r.stdout[-4000:] + r.stderr[-4000:])
    lib = ctypes.CDLL(str(so))
    for name in ("paged_chunk_attention", "paged_attention"):
        getattr(lib, name).argtypes = _build.ARGTYPES[name]
    print(cs.card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = cs.Timer()
    stream = torch.cuda.current_stream().cuda_stream
    lens = torch.randint(128, 1057, (32,), generator=gen, device="cuda").tolist()
    shapes = {"K1 decode": dict(b=32, t=1, lengths=lens),
              "K1 decode, every length 0": dict(b=32, t=1, lengths=[0] * 32),
              "K1 verify": dict(b=4, t=4, lengths=[1000] * 4),
              "K1 suffix_prefill": dict(b=1, t=255, lengths=[512]),
              "K3 decode": dict(b=32, t=1, lengths=lens)}
    for label, shp in shapes.items():
        case = cs.paged_case(gen, kv=2, g=6, hd=128, page=16, dtype=torch.bfloat16, **shp)
        b, t = shp["b"], shp["t"]
        splits = ops.n_splits(b, t, 2, 6, torch.device("cuda"))
        o = torch.empty_like(case["q"])
        mp = case["block_tables"].shape[1]
        if label.startswith("K3"):
            cc = cs.cached_case(case)

            def call():
                _build.check("k3", lib.paged_attention(
                    cc["q"].data_ptr(), cc["k_pages"].data_ptr(), cc["v_pages"].data_ptr(),
                    cc["block_tables"].data_ptr(), cc["lengths"].data_ptr(), o.data_ptr(),
                    None, None, None, b, 2, 6, 128, 16, mp, splits, 1, 128 ** -0.5, stream))
        else:
            def call():
                _build.check("k1", lib.paged_chunk_attention(
                    case["q"].data_ptr(), case["k_new"].data_ptr(), case["v_new"].data_ptr(),
                    case["k_pages"].data_ptr(), case["v_pages"].data_ptr(),
                    case["block_tables"].data_ptr(), case["lengths"].data_ptr(),
                    case["page_map"].data_ptr(), None, None, o.data_ptr(), None, None, None,
                    b, t, 2, 6, 128, 16, mp, splits, 1, 0, 128 ** -0.5, stream))
        ms = timer(call)
        lib.zero_prof()
        call()
        torch.cuda.synchronize()
        prof = (ctypes.c_longlong * 8)()
        lib.read_prof(prof)
        tiles = max(1, prof[3])
        print(f"{label}: block 0 walks {prof[3]} tiles; cycles per tile: wait {prof[0] / tiles:.0f},"
              f" issue {prof[1] / tiles:.0f}, fold {prof[2] / tiles:.0f} (warm L2)", flush=True)
        rows = -(-(t * 6) // ops.TC_ROWS[t * 6 > ops.ONE_WARP_ROWS])
        n = b * 2 * rows * splits
        for cold in (True, False):
            if cold:
                timer.flush.zero_()
                torch.cuda._sleep(timer.SPIN_CYCLES)
            call()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (MAX_BLOCKS * STAMPS))()
            lib.read_stamps(buf)
            st = [[buf[i * STAMPS + j] for j in range(STAMPS)] for i in range(n)]
            t0 = min(s[0] for s in st)
            print(f"{label} b={b} t={t} splits={splits}: kernel {ms:.4f} ms cold; {n} blocks; "
                  f"{'cold' if cold else 'warm'} L2: last block starts "
                  f"{(max(s[0] for s in st) - t0) / 1e3:.2f} us after the first, last ends "
                  f"{(max(s[5] for s in st) - t0) / 1e3:.2f} us after it", flush=True)
            for j, name in enumerate(NAMES):
                d = [s[j + 1] - s[j] for s in st]
                print(f"  {name:32s} mean {sum(d) / n / 1e3:7.2f} us, max {max(d) / 1e3:7.2f} us",
                      flush=True)
            d = [s[6] - s[1] for s in st if s[6] > s[1]]
            if d:
                print(f"  {'first tile landed (warp 0)':32s} mean {sum(d) / len(d) / 1e3:7.2f} us "
                      f"after the walk began", flush=True)
            d = [s[7] - s[3] for s in st]
            print(f"  {'first cluster barrier alone':32s} mean {sum(d) / n / 1e3:7.2f} us, "
                  f"max {max(d) / 1e3:7.2f} us", flush=True)
            for i in range(n):
                for j in range(STAMPS):
                    buf[i * STAMPS + j] = 0
        if label == "K1 decode":
            for wk, sp in ((1, splits), (0, 8)):
                ring = (3 if wk else 4) * 2 * 16 * (128 * 2 + 16)
                tiles = mp + 1
                np_max = (-(-tiles // sp) * 16 + 15) // 16 + 1
                smem = ((np_max * 4 + 127) & ~127) + ring
                blocks, clusters = ctypes.c_int(), ctypes.c_int()
                rc = lib.occupancy(wk, sp, smem, ctypes.byref(blocks), ctypes.byref(clusters))
                print(f"  occupancy one-warp={bool(wk)} smem={smem}: {blocks.value} blocks/SM, "
                      f"{clusters.value} clusters of {sp} at once (rc {rc})", flush=True)


if __name__ == "__main__":
    main()
