"""One run of one cell: set-up, the window, the check, the result line.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout.  The last line of standard
output is the result (JSON); the numbers the check compared, each beside
its limit, are the last lines of standard error and the result's last key.
``--device cpu --manifest bench/rehearsal.json`` rehearses the control flow
on the CPU with the kernels' plain versions (no result there is a
measurement)."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from benchlib import cell as C
from benchlib import check, files
from benchlib import trace as TR
from benchlib import traffic as T

#: modules the process that prints a result may not hold (top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--manifest", type=Path,
                    default=files.ROOT / "BENCHMARK.json")
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def metrics_of(specs: List[Dict[str, Any]], win: C.Window
               ) -> Dict[str, Dict[str, Any]]:
    out = {}
    for m in specs:
        value = files.metric_reader(m["name"]).read(win)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(args: argparse.Namespace, t_start: int) -> Optional[Dict[str, Any]]:
    """The result of one run, or None where the run may print none."""
    cell = files.load_cell(args.workload, args.manifest)
    dev = args.device
    shards = cell.config["serve"].get("tp", 1)
    if cell.chips < shards:
        log(f"{cell.name} serves over tp {shards} shards, one a card, but "
            f"asks for {cell.chips} card(s)")
        return None
    if dev == "cuda" and (not torch.cuda.is_available()
                          or torch.cuda.device_count() < cell.chips):
        log(f"{cell.name} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count()} visible")
        return None
    if dev == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    tp = cell.traffic
    model = cell.config["model"]
    system = C.System(cell.config, tp, args.seed, dev)
    gen = T.ClosedLoop(tp, args.seed, model["vocab_size"])
    prof = TR.Profiler(dev) if args.trace else None
    win = C.run_window(system, gen, args.seconds, t_start, cell.chips, prof)
    peak = system.memory_peak()
    if dev == "cuda":
        st = torch.cuda.memory_stats()
        log(f"allocator: {st.get('num_alloc_retries', 0)} retries, "
            f"{st.get('reserved_bytes.all.peak', 0)} bytes reserved at peak")
    if prof is not None:
        events = prof.events()
        log(f"trace: {len(events)} device operations, "
            f"{sum(TR.MARK in e.name for e in events)} marks")
        win.trace = TR.reduce(events, cell.chips, win.rec.spans(),
                              *win.stretch)
        if win.trace:
            log(f"trace: busy s by card {win.trace['busy_by_card']} of "
                f"{win.trace['window_s']:.3f} s")
        prof = None
    weights = system.release()
    bad = forbidden_modules()
    if bad:
        log(f"modules loaded that the benchmark may not load: {bad}")
        return None

    due = win.window_turns()
    failed = sum(t.error is not None or not t.first_ns for t in due)
    done = check.finished(win.turns, win.t_open, win.t_close)
    lim = cell.limits
    picked = check.sample(done, args.seed, lim["sample_tokens"],
                          lim["sample_context"])
    t_ref = time.perf_counter()
    readings = check.gap_readings(files.reference_module(cell.config),
                                  model, weights, picked)
    t_ref = time.perf_counter() - t_ref
    readings.update(failed=failed, commit_mismatch=check.commit_mismatches(
        done, tp["branches"]))
    ok, checks = check.verdict(readings, lim)
    log("readings " + json.dumps(readings))
    errors = sorted({t.error for t in win.turns if t.error})
    for e in errors[:5]:
        log(f"request failed: {e}")
    log(f"kv pool: at most {win.pool_held_peak} of {win.pool_pages} pages "
        f"held in the window ({100 * win.pool_held_peak / win.pool_pages:.1f}"
        f"%), {win.counters['kv.prefix_evictions']:.0f} prefix-cache pages "
        f"evicted")
    steps = [(b - a) / 1e6 for a, b, _ in win.rec.steps if win.inside(a)]
    if steps:
        log(f"driver steps in the window: {len(steps)}, ms p50 "
            f"{sorted(steps)[len(steps) // 2]:.1f} max {max(steps):.1f}")
    log(f"window {win.window_s} s: {len(due)} requests due, "
        f"{len(done)} finished, {len(picked)} compared "
        f"({sum(len(t.prompt) for t in picked)} prompt tokens, reference "
        f"{t_ref:.1f} s), set-up {win.setup_s} s")
    specs = cell.per_layer if args.trace else cell.end_to_end
    result: Dict[str, Any] = {
        "correct": ok, "attempted": len(due), "failed": failed,
        "metrics": metrics_of(specs, win),
        "device": device_record(dev, cell.chips, peak, win.trace)}
    if win.trace:
        result["breakdown"] = {"device_ops": win.trace["device_ops"],
                               "idle_gaps": win.trace["idle_gaps"]}
    result["checks"] = checks
    return result


def device_record(dev: str, chips: int, peak: int,
                  trace: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    if dev == "cpu":
        rec = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    else:
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": chips, "memory_peak_bytes": peak}
    if trace:
        rec["busy_s"] = trace["busy_s"]
        rec["window_s"] = trace["window_s"]
    return rec


def main(argv: List[str], t_start: int) -> int:
    args = parse(argv)
    result = run(args, t_start)
    if result is None:
        return 2
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0
