#!/usr/bin/env python3
"""Per-phase clock64() profile of the bf16 flash-attention kernel on the card.

Run from the repository root on a machine with one CUDA card:

    python3 tools/k2_profile.py

It copies ``flash_attention.cu``, inserts a clock64() read after each phase
of the key-tile loop of ``flash_attention_tc_kernel`` (thread 0 of the
first block, which owns the last, heaviest query tile, records), builds the
copy with the port's nvcc flags under ``build/k2_profile/``, runs it at
qwen2-1.5b's prefill widths (b 1, 12 heads, 2 KV heads, hd 128) for s 1023
and 2048, and prints the mean cycles per key tile of each phase beside the
kernel's time.  An anchor missing from the source fails the run.
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

MARKS = [
    ("    mbar_wait(&bars[1 + st], (j / STAGES) & 1);\n", 1),
    ("    wgmma_wait<0>();\n    fence_regs(sc);\n", 2),
    ("    for (int i = 0; i < HD / 2; ++i) o[i] *= ((i >> 1) & 1) ? a1 : a0;\n", 3),
    ("    wgmma_wait<0>();\n    fence_regs(o);\n", 4),
    ("    if (tid == 0 && j + STAGES < n_kv) load_kv(st, j + STAGES);\n", 5),
]
NAMES = {1: "wait for the K/V tile", 2: "S = Q K^T", 3: "softmax, split P",
         4: "O += P V", 5: "barrier, reload"}


def patched_source() -> str:
    src = (ROOT / "src/repro_torch/kernels/flash_attention/csrc/"
           "flash_attention.cu").read_text()
    for anchor, i in MARKS:
        if src.count(anchor) != 1:
            sys.exit(f"anchor not found once in flash_attention.cu: {anchor!r}")
        src = src.replace(anchor, anchor + f"    PROF({i});\n")
    src = src.replace(
        '#include "hopper.cuh"\n',
        '#include "hopper.cuh"\n__device__ long long g_prof[8];\n'
        "#define PROF(i) do { if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)"
        " { long long n_ = clock64(); g_prof[i] += n_ - t_; t_ = n_; } } while (0)\n")
    loop = "  for (int j = 0; j < n_kv; ++j) {\n    const int st = j % STAGES;\n"
    if src.count(loop) != 1:
        sys.exit("the key-tile loop was not found")
    src = src.replace(loop, "  long long t_ = clock64();\n" + loop)
    src += ('\nextern "C" int read_prof(long long* out) { return (int)'
            "cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * 8); }\n"
            'extern "C" int zero_prof() { long long z[8] = {0}; return (int)'
            "cudaMemcpyToSymbol(g_prof, z, sizeof z); }\n")
    return src


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    out = ROOT / "build" / "k2_profile"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "flash_attention_profile.cu", out / "flash_attention_profile.so"
    cu.write_text(patched_source())
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS,
                        f"-I{ROOT}/src/repro_torch/kernels/flash_attention/csrc",
                        "-o", str(so), str(cu)], capture_output=True, text=True)
    if r.returncode:
        sys.exit(r.stdout[-4000:] + r.stderr[-4000:])
    lib = ctypes.CDLL(str(so))
    lib.flash_attention.argtypes = _build.ARGTYPES["flash_attention"]
    print(cs.card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = cs.Timer()
    for s in (1023, 2048):
        q, k, v = cs.flash_case(gen, s=s)
        out_t = torch.empty_like(q)

        def call():
            rc = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     out_t.data_ptr(), 1, s, 12, 2, 128, 1,
                                     128 ** -0.5,
                                     torch.cuda.current_stream().cuda_stream)
            _build.check("flash_attention", rc)
        call()
        torch.cuda.synchronize()
        lib.zero_prof()
        call()
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * 8)()
        lib.read_prof(buf)
        tiles = -(-s // 64)
        ms = timer(call)
        print(f"s={s}: {ms:.4f} ms; the heaviest block's {tiles} key tiles, "
              f"{sum(buf[1:6]) / tiles:.0f} cycles each", flush=True)
        for i, name in NAMES.items():
            print(f"  {name:24s} {buf[i] / tiles:8.0f}", flush=True)


if __name__ == "__main__":
    main()
