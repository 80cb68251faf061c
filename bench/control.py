#!/usr/bin/env python3
"""Readings that set a cell's limits on the check's gap readings.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 --seconds 10
        [--fault <name>]

runs the cell once per seed in one process (a short window at the cell's
own load, then the same sample of finished requests as a benchmark run
draws) and prints one JSON line per seed: the program's readings (its
greedy tokens under the float32 reference: the widest gap below the
reference's best, the share not its first choice, the mean gap) and the
control's (at each position of the same prompts and tokens, the same
readings of the token that the reference computed one precision lower puts
first: float8 for a bfloat16 configuration, bfloat16 for a float32 one),
each with the verdict the cell's limits give it (``correct``).  With
``--fault`` the program runs with that fault planted under its timed path
(``benchlib/faults.py``), and the control is not read.  The benchmark's own runs do not run the
control."""

import time

T_START = time.perf_counter_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import torch  # noqa: E402

from benchlib import cell as C  # noqa: E402
from benchlib import check, faults, files  # noqa: E402
from benchlib import traffic as T  # noqa: E402


def readings(cell: files.Cell, seed: int, seconds: float, device: str,
             t_start: int, control: bool = True) -> dict:
    model = cell.config["model"]
    system = C.System(cell.config, cell.traffic, seed, device)
    gen = T.ClosedLoop(cell.traffic, seed, model["vocab_size"])
    win = C.run_window(system, gen, seconds, t_start, cell.chips)
    weights = system.release()
    done = check.finished(win.turns, win.t_open, win.t_close)
    lim = cell.limits
    picked = check.sample(done, seed, lim["sample_tokens"],
                          lim["sample_context"])
    ref = files.reference_module(cell.config)
    seqs, starts, served = check.greedy_rows(picked)
    t0 = time.perf_counter()
    exact = ref.score(model, weights, seqs, starts)
    t1 = time.perf_counter()
    low = (ref.score(model, weights, seqs, starts,
                     precision=ref.LOWER[model["dtype"]]) if control else [])
    t2 = time.perf_counter()
    prog = [ref.gaps(e, s) for e, s in zip(exact, served)]
    ctrl = [ref.gaps(e, lw.argmax(-1).tolist()) for e, lw in zip(exact, low)]
    n = sum(len(s) for s in served)
    held = {"failed": sum(t.error is not None or not t.first_ns
                          for t in win.window_turns()),
            "commit_mismatch": check.commit_mismatches(
                done, cell.traffic["branches"])}
    out = {"seed": seed}
    for side, rows in (("program", prog), ("control", ctrl)):
        if not rows:
            continue
        r = dict(check.readings_of(rows), **held)
        ok, _ = check.verdict(r, lim)
        out[side] = dict(r, correct=ok)
    out.update(program_gaps=[float(g.max()) for g in prog],
               control_gaps=[float(g.max()) for g in ctrl],
               tokens=n, context=sum(len(s) for s in seqs),
               reference_s=t1 - t0, control_s=t2 - t1,
               finished=len(done), setup_s=win.setup_s,
               pool_held_share=win.pool_held_peak / win.pool_pages,
               prefix_evictions=win.counters["kv.prefix_evictions"])
    del weights, exact, low
    if device != "cpu":
        cards = range(torch.cuda.device_count())
        out["memory_peak_bytes"] = max(torch.cuda.max_memory_allocated(i)
                                       for i in cards)
        torch.cuda.empty_cache()
        for i in cards:
            torch.cuda.reset_peak_memory_stats(i)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--fault", choices=sorted(faults.table()[1]))
    ap.add_argument("--manifest", type=Path,
                    default=files.ROOT / "BENCHMARK.json")
    args = ap.parse_args()
    cell = files.load_cell(args.workload, args.manifest)
    if args.fault:
        faults.plant(args.fault)
    if args.device == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    t = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.seconds, args.device, t,
                                  control=not args.fault)), flush=True)
        t = time.perf_counter_ns()
    return 0


if __name__ == "__main__":
    sys.exit(main())
