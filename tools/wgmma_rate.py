#!/usr/bin/env python3
"""Cycles per wgmma for the operand layouts of the port's tensor-core kernels.

Run from the repository root on a machine with one CUDA card:

    python3 tools/wgmma_rate.py

Builds ``tools/wgmma_rate.cu`` with the port's nvcc flags into
``build/wgmma_rate/`` and prints, for each layout, the cycles per wgmma of
256 groups of four k16 products in one warpgroup, chained and waited, and
the multiply-adds per cycle beside the H100's ~2048 per SM (989 TFLOP/s
bf16 over 132 SMs at ~1.83 GHz).
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

LAYOUTS = [("m64n64k16, K-major A and B (G, S = Q K^T)", 64),
           ("m64n64k16, K-major A, N-major B hi|lo panels (y2)", 64),
           ("m64n64k16, M-major A, N-major B hi|lo panels (u)", 64),
           ("m64n32k16, K-major A, N-major B (y2 per term)", 32),
           ("m64n32k16, register A, N-major B (y = W x)", 32),
           ("m64n128k16, register A, N-major B (O += P V)", 128)]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    out = ROOT / "build" / "wgmma_rate"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "wgmma_rate.so"
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                        str(Path(__file__).parent / "wgmma_rate.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        sys.exit(r.stdout[-4000:] + r.stderr[-4000:])
    lib = ctypes.CDLL(str(so))
    lib.wgmma_rate.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_int]
    buf = torch.zeros(2, dtype=torch.int64, device="cuda")
    reps = 256
    print(cs.card_line(), flush=True)
    for v, (name, n) in enumerate(LAYOUTS):
        cyc = []
        for wait in (0, 1):
            _build.check("wgmma_rate", lib.wgmma_rate(v, wait, buf.data_ptr(), reps))
            torch.cuda.synchronize()
            cyc.append(buf[0].item() / (reps * 4))
        mac = 64 * n * 16
        print(f"{name}: {cyc[0]:.1f} cycles chained ({mac / cyc[0]:.0f} MAC/cycle), "
              f"{cyc[1]:.1f} waited per group of 4", flush=True)


if __name__ == "__main__":
    main()
