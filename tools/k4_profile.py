#!/usr/bin/env python3
"""Per-phase clock64() profile of the bf16 SSD-scan kernel on the card.

Run from the repository root on a machine with one CUDA card:

    python3 tools/k4_profile.py

It copies ``ssd_scan.cu``, inserts a clock64() read after each phase of the
chunk loop of ``ssd_scan_tc_kernel`` (the y path's thread 0 and the state
path's thread 128 of one block record), builds the copy with the port's
nvcc flags under ``build/k4_profile/``, runs it at mamba2-2.7b's widths
(s 4096, P 64, N 128) for 80, 40 and 20 heads, and prints the mean cycles
per chunk of each phase and the kernel's time.  Fewer heads leave an SM
with one block instead of two, so the per-chunk cycles show whether the
blocks' own dependent chains or their sharing of an SM set the time.  An
anchor missing from the source (the kernel was edited) fails the run.
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

# (text after which a phase ends, phase index); 0-9 the y path, 10-15 the
# state path
MARKS = [
    ("      for (int i = 0; i < 16; ++i) y2[i] = yc[i] = 0.f;\n"
     "      mbar_wait(&full[st], (c / STAGES) & 1);\n", 1),
    ("      mbar_wait(&sc_ready[sb], (c >> 1) & 1);\n", 2),
    ("      wgmma_wait<0>();\n      fence_regs(g);\n", 3),
    ("        split_pack(w0, w1, w_hi[i / 2], w_lo[i / 2]);\n      }\n", 4),
    ("        wgmma_rs_n32<1>(yc, al, dx);\n      }\n      wgmma_commit();\n", 5),
    ("      mbar_wait(s_ready, c & 1);  // S entering chunk c\n", 6),
    ("      fence_regs(yc);\n      fence_regs(y2);\n", 7),
    ("      if (tid == 0 && c + STAGES < nc) {\n        mbar_wait(&empty[st], "
     "(c / STAGES) & 1);\n        load_chunk(st, c + STAGES);\n      }\n", 8),
    ("      named_sync(1, 128);  // the chunk's scalars\n", 11),
    ("      mbar_wait(&full[st], (c / STAGES) & 1);\n      {\n", 12),
    ("      named_sync(1, 128);  // the w o x tiles\n", 13),
    ("      mbar_arrive(&empty[st]);\n      mbar_wait(s_read, c & 1);", 14),
    ("      write_s_tiles();           // S entering chunk c + 1\n", 15),
]
NAMES = {1: "y: wait for the tiles", 2: "y: issue G, wait for the scalars",
         3: "y: wait G", 4: "y: W", 5: "y: issue y = W x",
         6: "y: wait for the S tiles", 7: "y: y2 = C S, wait all",
         8: "y: store y, reload", 11: "state: scan",
         12: "state: wait for the tiles", 13: "state: w o x tiles",
         14: "state: u, S update, wait for y2", 15: "state: write S tiles"}


def patched_source() -> str:
    src = (ROOT / "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu").read_text()
    for anchor, i in MARKS:
        if src.count(anchor) != 1:
            sys.exit(f"anchor not found once in ssd_scan.cu: {anchor!r}")
        src = src.replace(anchor, anchor + f"      PROF({i});\n")
    src = src.replace(
        '#include "hopper.cuh"\n',
        '#include "hopper.cuh"\n__device__ long long g_prof[16];\n'
        "#define PROF(i) do { if (blockIdx.x == PROF_BLOCK && (threadIdx.x & 127) == 0)"
        " { long long n_ = clock64(); g_prof[i] += n_ - t_; t_ = n_; } } while (0)\n")
    loops = ("    for (int c = 0; c < nc; ++c) {\n      const int st = c % STAGES;\n")
    if src.count(loops) != 2:
        sys.exit("the two chunk loops were not found")
    src = src.replace(loops, "    long long t_ = clock64();\n" + loops)
    src += ('\nextern "C" int read_prof(long long* out) { return (int)'
            "cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * 16); }\n"
            'extern "C" int zero_prof() { long long z[16] = {0}; return (int)'
            "cudaMemcpyToSymbol(g_prof, z, sizeof z); }\n")
    return src


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    out = ROOT / "build" / "k4_profile"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "ssd_scan_profile.cu", out / "ssd_scan_profile.so"
    cu.write_text(patched_source())
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-DPROF_BLOCK=0",
                        f"-I{ROOT}/src/repro_torch/kernels/ssd_scan/csrc",
                        "-o", str(so), str(cu)], capture_output=True, text=True)
    if r.returncode:
        sys.exit(r.stdout[-4000:] + r.stderr[-4000:])
    lib = ctypes.CDLL(str(so))
    lib.ssd_scan.argtypes = _build.ARGTYPES["ssd_scan"]
    print(cs.card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = cs.Timer()
    s = 4096
    for H in (80, 40, 20):
        x, dt, A, B, C = cs.ssd_case(gen, s=s, H=H)
        y = torch.empty_like(x)
        state = torch.empty(1, H, 128, 64, device="cuda")

        def call():
            rc = lib.ssd_scan(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                              B.data_ptr(), C.data_ptr(), y.data_ptr(),
                              state.data_ptr(), 1, s, H, 64, 128, 1,
                              torch.cuda.current_stream().cuda_stream)
            _build.check("ssd_scan", rc)
        call()
        torch.cuda.synchronize()
        lib.zero_prof()
        call()
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * 16)()
        lib.read_prof(buf)
        nc = -(-s // 64)
        ms = timer(call)
        print(f"H={H} ({2 * H} blocks), s={s}: {ms:.4f} ms; cycles per chunk, "
              f"y path {sum(buf[1:9]) / nc:.0f}, state path "
              f"{sum(buf[11:16]) / nc:.0f}", flush=True)
        for i, name in NAMES.items():
            print(f"  {name:32s} {buf[i] / nc:8.0f}", flush=True)


if __name__ == "__main__":
    main()
