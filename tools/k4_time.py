#!/usr/bin/env python3
"""The bf16 SSD-scan kernel's time at the training and prefill shapes, from
one tree of the repository.

Run on a machine with one CUDA card, from the repository root:

    python3 tools/k4_time.py TREE LABEL

``TREE`` is the root of the tree whose kernel is timed (``.`` for this
one, or a ``git archive`` of another commit unpacked under ``build/``);
its ``chip_smoke.py`` supplies the inputs and the timer.  It builds that
tree's ``ssd_scan.cu`` and prints ``LABEL`` and the kernel's ms (one
cold-L2 launch, median of 20) at b 1 × s 2048 for mamba2-2.7b's and
zamba2-7b's model positions (H 40 N 128; H 56 N 64), at phase 13's b 2 ×
s 2048 × H 80 and at the prefill's b 1 × s 4096 × H 80.  To compare two
versions, run both in one call, alternating.
"""

import sys
from pathlib import Path

ROOT = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402

SHAPES = ((1, 2048, 40, 128), (1, 2048, 56, 64), (2, 2048, 80, 128),
          (1, 4096, 80, 128))                       # (b, s, H, N)


def main() -> None:
    _build.build_all(["ssd_scan"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = cs.Timer()
    out = []
    for b, s, H, N in SHAPES:
        args = cs.ssd_case(gen, s=s, H=H, N=N, b=b)
        out.append(f"b{b} s{s} H{H} N{N} "
                   f"{timer(lambda: ssd_scan(*args)):.4f}")
    print(sys.argv[2], "; ".join(out), flush=True)


if __name__ == "__main__":
    main()
