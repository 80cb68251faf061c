#!/usr/bin/env python3
"""How often the fused decode step replays its CUDA graphs in one run of a
benchmark cell.

    python3 tools/decode_graph_counts.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout, on the card.  Runs the cell as
``bench/run.py`` does (its result line is printed the same way), and adds
one last line, ``decode_graphs {...}``: the engine's decode steps, graph
replays, captures and padded rows over the window and over the whole run,
the replay share of the window's steps, each capture's milliseconds, and
how many captures began in set-up, in the window and in the traced
stretch.  It reads the counters through private names of ``bench/``; once
the benchmark reads them itself, this tool goes."""

import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter_ns()

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

from benchlib import cell as C  # noqa: E402
from benchlib.harness import main  # noqa: E402

from repro_torch.runtime.serve_loop import ServeEngine  # noqa: E402

COUNTS = ("engine.decode_steps", "engine.decode_graph_replays",
          "engine.decode_graph_captures", "engine.decode_padded_rows")


def run(argv):
    C.COUNTERS = C.COUNTERS + COUNTS
    captured, seen = [], {}
    real_capture, real_window = ServeEngine._capture, C.run_window

    def capture(self, rung):
        t0 = time.perf_counter_ns()
        real_capture(self, rung)
        captured.append((t0, rung.rows))

    def run_window(system, *args, **kw):
        win = real_window(system, *args, **kw)
        m = system.engine.obs.metrics
        window = {k: win.counters[k] for k in COUNTS}
        stretch = win.stretch or (0, 0)
        seen.update(
            window=window,
            run={k: m.counter(k).value for k in COUNTS},
            replay_share=(window["engine.decode_graph_replays"]
                          / max(1, window["engine.decode_steps"])),
            capture_ms=m.histogram("engine.decode_graph_capture_ms")
            .snapshot(),
            captures_in_setup=sum(t < win.t_open for t, _ in captured),
            captures_in_window=sum(win.inside(t) for t, _ in captured),
            captures_in_stretch=sum(stretch[0] <= t < stretch[1]
                                    for t, _ in captured),
            rungs_captured=sorted(r for _, r in captured))
        return win

    ServeEngine._capture = capture
    C.run_window = run_window
    rc = main(argv, T_START)
    print("decode_graphs " + json.dumps(seen), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
