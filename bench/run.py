#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout; see ``benchlib/harness.py``.  Every build and
kernel cache the run makes lies under ``build/`` in the checkout, at fixed
paths, so that only a checkout's first run compiles."""

import time

T_START = time.perf_counter_ns()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "bench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
# one process, few threads: the host path is one Python thread launching
# kernels, and idle pool threads would only contend with it for the cores
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [str(HERE), str(ROOT / "src")]

from benchlib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
