"""The check of ``correct`` on the CPU rehearsal cells: a sound run passes,
the control (the reference one precision lower) is not correct, and each
fault that a serving cell can have, planted under the timed path, turns
``correct`` false: on the one-card cell those of one shard, on the cell
served over tp 2 those and the exchange between shards left out."""

import time

import pytest
import torch

from benchlib import faults, files, harness

CELL = "paper-agentic.agent-tiny"
TP2 = "paper-agentic-tp2.agent-tiny"
MANIFEST = files.BENCH_DIR / "rehearsal.json"
#: (cell, fault): every fault each rehearsal cell can have
PLANTED = ([(CELL, f) for f in sorted(faults.table()[1])
            if f not in faults.ACROSS_CARDS]
           + [(TP2, f) for f in sorted(faults.table()[1])])


def run_cell(seed=3, seconds=2.0, cell=CELL):
    args = harness.parse(["--workload", cell, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", "0",
                          "--device", "cpu", "--manifest", str(MANIFEST)])
    return harness.run(args, time.perf_counter_ns())


def test_a_sound_run_is_correct():
    r = run_cell()
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert r["checks"]["greedy_tokens"]["value"] >= 8


def test_the_control_is_not_correct_on_any_seed():
    control = files.load_module(files.BENCH_DIR / "control.py")
    cell = files.load_cell(CELL, MANIFEST)
    runs = [control.readings(cell, seed, 2.0, "cpu", time.perf_counter_ns())
            for seed in (21, 22, 23)]
    for r in runs:
        assert r["program"]["correct"] is True, r
        assert r["control"]["correct"] is False, r


def test_the_control_over_shards_is_not_correct():
    control = files.load_module(files.BENCH_DIR / "control.py")
    cell = files.load_cell(TP2, MANIFEST)
    r = control.readings(cell, 21, 2.0, "cpu", time.perf_counter_ns())
    assert r["program"]["correct"] is True, r
    assert r["control"]["correct"] is False, r


@pytest.mark.parametrize("cell,fault", PLANTED)
def test_a_planted_fault_is_not_correct(monkeypatch, cell, fault):
    cls, table = faults.table()
    monkeypatch.setattr(cls, faults.replaced(table[fault]), table[fault])
    with torch.no_grad():
        r = run_cell(seed=5, cell=cell)
    assert r["correct"] is False, r["checks"]
    assert r["checks"]["max_gap"]["value"] > r["checks"]["max_gap"]["limit"]


def test_shared_pages_count_once():
    from benchlib import cell as C
    from benchlib import files as F

    cfg = F.load_json(F.BENCH_DIR / "configs" / "paper-agentic.json")
    tp = F.load_json(F.BENCH_DIR / "traffic" / "agent-tiny.json")
    eng = C.System(cfg, tp, 1, "cpu").engine
    root = eng.add_request(list(range(41)))          # 40 cached positions
    kids = eng.fork(root, 4)
    assert C.distinct_positions(eng, kids) == 40
    eng.decode(kids)                                 # each copies its tail
    # two full pages shared, four 9-position tails of their own
    assert C.distinct_positions(eng, kids) == 32 + 4 * 9
