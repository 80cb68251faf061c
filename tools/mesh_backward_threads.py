#!/usr/bin/env python3
"""What running each mesh position's backward on one thread costs, on one
card.

Run from the repository root on a machine with one CUDA card:

    python3 tools/mesh_backward_threads.py

``train_loop.sharded_value_and_grad`` runs each data position's backward
with the autograd engine's per-device threads off
(``torch.autograd.set_multithreading_enabled(False)``): over several
cards a remat'd layer spans its model positions' cards, and two device
threads would both recompute it.  This times ``mamba2-2.7b`` at full
width in bf16, b 2 × s 2048, over a (data 2, model 2) mesh of cuda:0
through ``build_train_step``: two steps with the threads on (the setting
patched to PyTorch's default) and two off, three rounds alternating,
and prints each side's step ms and median.
"""

import contextlib
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLMPipeline  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.train_loop import (  # noqa: E402
    build_train_step,
    init_train_state,
)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    _build.build_all(["ssd_scan"])
    print(cs.card_line(), flush=True)
    cfg = get_config("mamba2-2.7b")
    model = Model(cfg, plan=cs.card_plan(4, 2))
    opt = adamw(1e-4)
    state = init_train_state(model, opt, torch.Generator(
        device="cuda").manual_seed(0))
    step = build_train_step(model, opt, clip_norm=1.0)
    batch = SyntheticLMPipeline(cfg, batch=2, seq=2048, seed=0,
                                device="cuda").next()
    real = torch.autograd.set_multithreading_enabled
    times = {"threads on": [], "threads off": []}
    step(state, batch)
    torch.cuda.synchronize()
    try:
        for _ in range(3):
            for mode in times:
                torch.autograd.set_multithreading_enabled = (
                    (lambda m: contextlib.nullcontext())
                    if mode == "threads on" else real)
                for _ in range(2):
                    t = time.perf_counter()
                    step(state, batch)
                    torch.cuda.synchronize()
                    times[mode].append(round(
                        (time.perf_counter() - t) * 1e3, 1))
    finally:
        torch.autograd.set_multithreading_enabled = real
    for mode, ms in times.items():
        print(mode, ms, "median", statistics.median(ms), flush=True)


if __name__ == "__main__":
    main()
