#!/usr/bin/env python3
"""Where the bf16 SSD-scan kernel's final-state error comes from, on the
card.

Run from the repository root on a machine with one CUDA card:

    python3 tools/k4_state_error.py

For a few seeds at each shape (b 1, s 2048, P 64: zamba2-7b's model
position H 56 N 64, mamba2-2.7b's H 40 N 128, and the main path's H 80
N 128) it runs the kernel (``ssd_scan`` on bf16 inputs), the plain
version in f32 on the card (``ssd_scan_ref``, the reference the smoke test
holds it against) and ``tests/test_torch_tc_numerics.py``'s emulation of
the kernel's arithmetic (64-row chunks, f32 operands split into bf16
terms, f32 sums) on the same inputs, with the kernel's term counts and
with a third term for every split, on the head where the kernel's
error is largest (the emulation runs on the CPU).  It prints the kernel's
largest state error against the plain version beside ``chip_smoke.py``'s
f32 tolerance (2e-5 absolute), where it lies (head, |ref| there, the
head's dt and A), and the emulations' errors on that head.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import test_torch_tc_numerics as tc  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd_scan import ops, ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402

SHAPES = ((56, 64), (40, 128), (80, 128))   # (H, N) at b 1, s 2048, P 64
SEEDS = 3


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["ssd_scan"])
    print(cs.card_line(), flush=True)
    three = {k: 3 for k in ops.SPLIT_TERMS}
    for H, N in SHAPES:
        for seed in range(SEEDS):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            x, dt, A, B, C = cs.ssd_case(gen, s=2048, H=H, N=N, b=1)
            f32 = (x.float(), dt, A, B.float(), C.float())
            _, st_ref = ssd_scan_ref(*f32)
            _, st = ssd_scan(x, dt, A, B, C)
            k = (st - st_ref).abs()
            b, h, n, p = (int(i) for i in torch.unravel_index(
                k.argmax(), k.shape))
            # the emulation (on the CPU) of that head alone: the heads
            # share only B and C
            one = [t.cpu() for t in (x[:, :, h:h + 1], dt[:, :, h:h + 1],
                                     A[h:h + 1], B, C)]
            errs = {"kernel": float(k.max())}
            for name, terms in (("emulated", ops.SPLIT_TERMS),
                                ("emulated, 3 terms", three)):
                errs[name] = float((tc.ssd_tc(*one, terms)[1][:, 0]
                                    - st_ref[:, h].cpu()).abs().max())
            print(f"H {H} N {N} seed {seed}: max|ref| "
                  f"{float(st_ref.abs().max()):.4f}; at head {h} (|ref| "
                  f"{float(st_ref[b, h, n, p].abs()):.4f}, mean dt "
                  f"{float(dt[b, :, h].mean()):.4g}, A {float(A[h]):.3g}) "
                  "the state's max error: " + ", ".join(
                      f"{name} {e:.3e}" for name, e in errs.items())
                  + " (tol 2e-5)", flush=True)


if __name__ == "__main__":
    main()
