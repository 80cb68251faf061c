"""The serving path's spans on the engine track (``repro_torch.obs``): the
engine's decode step, prefills, forks and commits, the scheduler's step and
the exploration driver's round, each with its phases and arguments.

``paper-agentic`` at float32 on the CPU.  The tracer reads a counting clock,
so every reading is distinct and ordered: a phase ends at the reading the
next one starts at, and a span's closing reading also ends whatever phase
is still open under it.  A span's parent is the shortest other span that
holds it.  Disabled, the same calls must never read that clock."""

import dataclasses
import itertools

import pytest
import torch

from repro_torch.api import BranchSession
from repro_torch.configs import get_config
from repro_torch.core.errors import PoolExhausted
from repro_torch.explore_ctx import ExplorationDriver, best_of_n
from repro_torch.models import Model
from repro_torch.obs import ENGINE_TRACK, Observability, Tracer
from repro_torch.runtime.serve_loop import ServeEngine

PAGE = 4
DECODE_PHASES = ["engine.decode.prepare", "engine.decode.upload",
                 "engine.decode.forward", "engine.decode.sample",
                 "engine.decode.readback"]


@pytest.fixture(scope="module")
def model_params():
    cfg = dataclasses.replace(get_config("paper-agentic"), dtype="float32")
    model = Model(cfg)
    return model, model.init(torch.Generator().manual_seed(0), device="cpu")


def hub(trace, clock):
    obs = Observability(trace=trace)
    obs.tracer = Tracer(enabled=trace, clock=clock)
    return obs


def engine(model_params, obs, **kw):
    model, params = model_params
    kw.setdefault("num_pages", 64)
    kw.setdefault("prefix_cache", True)
    return ServeEngine(model, params, page_size=PAGE, max_pages_per_seq=16,
                       device="cpu", obs=obs, **kw)


def counting_clock():
    reads = itertools.count()
    calls = []

    def clock():
        calls.append(1)
        return next(reads)
    return clock, calls


def engine_calls(eng):
    """A dense prefill, a suffix prefill over the first one's two cached
    pages, a fork, a decode of the fork (one greedy row, one sampled) and
    a commit.  Returns the two prompts and the sequence ids."""
    first = list(range(1, 12))                     # 10 tokens to prefill
    second = first[:2 * PAGE] + [40, 41, 42, 43, 44, 45]
    a = eng.add_request(first)
    b = eng.add_request(second)
    kids = eng.fork(a, 2)
    eng.decode(kids, greedy=[True, False], temperature=[1.0, 1.5])
    eng.commit(kids[0])
    return (first, second), (a, b, kids)


def driver_rounds(eng):
    """Best-of-2 of two tokens each through the public driver, to the end."""
    session = BranchSession(eng, max_batch=8, seed=0)
    driver = ExplorationDriver(session)
    exp = driver.explore([7, 3, 9, 2, 5], max_new_tokens=4, policy=best_of_n,
                         n=2, tokens=2, temperature=1.5)
    driver.run()
    assert exp.result is not None
    return driver.steps


def exhaust(eng):
    """A decode the pool cannot hold (four CoW faults, two free pages),
    then one it can; returns the second decode's rows."""
    root = eng.add_request(list(range(1, 10)))     # 8 cached: 2 pages
    kids = eng.fork(root, 4)
    with pytest.raises(PoolExhausted):
        eng.decode(kids)
    eng.decode(kids[:2])
    return kids[:2]


def tree(tr):
    """(span, parent span or None) for every closed engine-track span."""
    spans = [s for s in tr.spans if s.track == ENGINE_TRACK]
    out = []
    for s in spans:
        holders = [p for p in spans if p is not s
                   and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns]
        out.append((s, min(holders, key=lambda p: p.duration_ns)
                     if holders else None))
    return out


def children(pairs, parent):
    return sorted((s for s, p in pairs if p is parent),
                  key=lambda s: s.start_ns)


def named(pairs, name):
    return [s for s, _ in pairs if s.name == name]


def test_engine_calls_record_spans_phases_and_args(model_params):
    clock, _ = counting_clock()
    eng = engine(model_params, hub(True, clock))
    (first, second), (a, b, kids) = engine_calls(eng)
    tr = eng.obs.tracer
    assert not tr.has_open(ENGINE_TRACK)
    pairs = tree(tr)
    assert all(s.status == "ok" for s, _ in pairs)

    dense, suffix = named(pairs, "engine.add_request")
    for span, prompt, seq in ((dense, first, a), (suffix, second, b)):
        assert span.args["seq"] == seq
        assert span.args["cached"] + span.args["new"] == len(prompt) - 1
    assert (dense.args["cached"], suffix.args["cached"]) == (0, 2 * PAGE)
    for span, kind in ((dense, "dense"), (suffix, "suffix")):
        phases = children(pairs, span)
        assert [s.name for s in phases] == [
            "engine.prefill.match", "engine.prefill.pass",
            "engine.prefill.scatter", "engine.prefill.register"]
        assert phases[1].args == {"kind": kind}
        # pass and scatter follow each other at one clock reading
        assert phases[1].end_ns == phases[2].start_ns

    (fork,) = named(pairs, "engine.fork")
    assert fork.args == {"seq": a, "n": 2}
    (commit,) = named(pairs, "engine.commit")
    assert commit.args == {"seq": kids[0]}

    # the registry keeps its histograms but the one the add_request span
    # replaced, whose clock stopped at the prefill's enqueue
    hists = eng.obs.metrics.snapshot()["histograms"]
    assert "engine.prefill_us" not in hists
    assert {"engine.fork_us", "engine.commit_us",
            "engine.decode_step_us"} <= set(hists)

    (decode,) = named(pairs, "engine.decode")
    assert decode.args["rows"] == 2
    assert decode.args["cow"] == 2     # each child faults the shared tail
    phases = children(pairs, decode)
    assert [s.name for s in phases] == DECODE_PHASES
    # two rows on rung 2; no graph off the card
    assert phases[2].args == {"layers": eng.cfg.num_layers, "graph": 0,
                              "rung": 2}
    # the phases tile the step, from its first reading to its readback
    assert all(x.end_ns == y.start_ns for x, y in zip(phases, phases[1:]))
    assert decode.start_ns < phases[0].start_ns
    assert phases[-1].end_ns <= decode.end_ns
    for s, p in pairs:
        if s.name.startswith(("engine.decode.", "engine.prefill.")):
            assert p.name in ("engine.decode", "engine.add_request")
        else:
            assert p is None       # top-level calls nest in no other


def test_driver_round_nests_scheduler_and_engine_spans(model_params):
    clock, _ = counting_clock()
    eng = engine(model_params, hub(True, clock))
    steps = driver_rounds(eng)
    tr = eng.obs.tracer
    assert not tr.has_open(ENGINE_TRACK)
    pairs = tree(tr)
    rounds = named(pairs, "driver.step")
    assert len(rounds) == steps
    assert rounds[0].args["live"] == 1
    for r in rounds:
        kids = children(pairs, r)
        assert [s.name for s in kids] == [
            "driver.admit", "driver.advance", "sched.step"]
        assert kids[0].end_ns == kids[1].start_ns
        assert kids[1].args["resumed"] in (0, 1)
        assert [s.name for s in children(pairs, kids[2])][-1] == \
            "sched.retire"
    parent_of = {s.name: set() for s, _ in pairs}
    for s, p in pairs:
        parent_of[s.name].add(p.name if p else None)
    assert parent_of["sched.step"] == {"driver.step"}
    assert parent_of["sched.retire"] == {"sched.step"}
    assert parent_of["engine.decode"] == {"sched.step"}
    # the policy's submit admits at once while pages allow (session.open);
    # driver.admit holds the admissions that waited
    assert parent_of["engine.add_request"] == {"driver.advance"}
    assert parent_of["engine.fork"] == {"driver.advance"}
    assert parent_of["engine.commit"] == {"driver.advance"}
    # the policy starts (submit, fork), then resumes when its branches
    # have decoded (score, commit)
    assert sum(r.args["resumed"] for r in
               named(pairs, "driver.advance")) == 2


def test_raising_decode_leaves_no_span_open(model_params):
    clock, _ = counting_clock()
    eng = engine(model_params, hub(True, clock), num_pages=4,
                 prefix_cache=False)
    rows = exhaust(eng)
    tr = eng.obs.tracer
    assert not tr.has_open(ENGINE_TRACK)
    pairs = tree(tr)
    failed, ok = named(pairs, "engine.decode")
    assert failed.status == "error" and ok.status == "ok"
    assert [(s.name, s.status) for s in children(pairs, failed)] == [
        ("engine.decode.prepare", "error")]
    assert ok.args == {"rows": len(rows), "cow": 0}   # fresh tail pages
    assert [(s.name, s.status) for s in children(pairs, ok)] == [
        (name, "ok") for name in DECODE_PHASES]


def test_disabled_tracer_reads_no_clock(model_params):
    clock, calls = counting_clock()
    eng = engine(model_params, hub(False, clock))
    engine_calls(eng)
    driver_rounds(eng)
    exhaust(engine(model_params, eng.obs, num_pages=4, prefix_cache=False))
    tr = eng.obs.tracer
    assert calls == []             # the clock was never consulted
    assert tr.spans == [] and tr.instants == [] and tr.open_spans == []
