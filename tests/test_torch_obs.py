"""Port parity: observability (``repro_torch.obs``) against the JAX package's
``repro.obs``.

Each scenario of ``tests/test_obs.py`` runs once per package through a
namespace of that package's modules, keeps the reference test's own
asserts, and returns a record — histogram buckets and percentiles, the
procfs text, span and instant tracks and statuses, the Chrome trace's
structure, engine counters — that must be equal across the two.  The
engine scenarios run ``paper-agentic`` at float32 from one set of weights,
the port on the CPU, the JAX engine on its fused path; the 8-way
``best_of_n`` samples, so its trace is held on structure (the tree, one
commit, the invalidated losers), not on which branch won.
"""

import dataclasses
import json
import types

import jax
import numpy as np
import pytest

import repro.api as jax_api
import repro.core.lifecycle as jax_lifecycle
import repro.explore_ctx as jax_explore
import repro.obs as jax_obs
import repro.obs.metrics as jax_metrics
import repro.obs.tracer as jax_tracer
import repro.runtime.serve_loop as jax_serve
import repro_torch.api as port_api
import repro_torch.core.lifecycle as port_lifecycle
import repro_torch.explore_ctx as port_explore
import repro_torch.obs as port_obs
import repro_torch.obs.metrics as port_metrics
import repro_torch.obs.tracer as port_tracer
import repro_torch.runtime.serve_loop as port_serve
from repro.configs import get_config
from repro.models.model import Model as JaxModel
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as port_config
from repro_torch.models import Model


@pytest.fixture(scope="module")
def pkgs():
    jcfg = dataclasses.replace(get_config("paper-agentic"), dtype="float32")
    pcfg = dataclasses.replace(port_config("paper-agentic"), dtype="float32")
    jmodel = JaxModel(jcfg, attn_chunk=8, remat=False)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    pparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    pmodel = Model(pcfg)
    return {
        "jax": types.SimpleNamespace(
            obs=jax_obs, metrics=jax_metrics, tracer=jax_tracer,
            lifecycle=jax_lifecycle, api=jax_api, x=jax_explore,
            engine=lambda **kw: jax_serve.ServeEngine(
                jmodel, jparams, attn_impl="fused_ref", **geometry(kw))),
        "port": types.SimpleNamespace(
            obs=port_obs, metrics=port_metrics, tracer=port_tracer,
            lifecycle=port_lifecycle, api=port_api, x=port_explore,
            engine=lambda **kw: port_serve.ServeEngine(
                pmodel, pparams, device="cpu", **geometry(kw))),
    }


def geometry(kw):
    kw.setdefault("num_pages", 128)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_pages_per_seq", 16)
    return kw


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def spans_of(tr):
    return sorted((s.track, s.name, s.status, s.parent) for s in tr.spans)


def instants_of(tr):
    return [(i.track, i.name) for i in tr.instants]


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

@scenario
def counter_gauge_basics(P):
    m = P.metrics.Metrics()
    c = m.counter("x.events")
    c.inc()
    c.inc(4)
    assert c.value == 5
    assert m.counter("x.events") is c          # get-or-create
    g = m.gauge("x.level")
    g.set(7)
    g.add(-2)
    assert g.value == 5
    with pytest.raises(TypeError) as exc:
        # the runtime guard branchlint BL005 front-runs, exercised
        m.gauge("x.events")  # branchlint: ignore[BL005]
    return c.value, g.value, str(exc.value), m.snapshot()


@scenario
def histogram_bucket_math(P):
    h = P.metrics.Histogram("t", lo=1.0, growth=2.0, buckets=4)
    assert h.bounds == [1.0, 2.0, 4.0, 8.0]
    for v in (0.5, 1.0, 1.5, 3.0, 8.0, 100.0):
        h.observe(v)
    assert h.counts == [2, 1, 1, 1, 1]
    assert h.count == 6
    assert h.min == 0.5 and h.max == 100.0
    snap = h.snapshot()
    assert snap["count"] == 6
    assert snap["buckets"] == {"1": 2, "2": 1, "4": 1, "8": 1, "inf": 1}
    return h.bounds, h.counts, snap


@scenario
def histogram_percentiles(P):
    h = P.metrics.Histogram("t", lo=1.0, growth=2.0, buckets=10)
    for _ in range(99):
        h.observe(3.0)       # bucket bound 4
    h.observe(1000.0)        # bound 1024
    assert h.percentile(50) == 4.0
    assert h.percentile(99) == 4.0
    assert h.percentile(100) == 1000.0   # capped at true max
    empty = P.metrics.Histogram("e")
    assert empty.percentile(50) == 0.0
    assert empty.snapshot()["min"] == 0.0
    return ([h.percentile(p) for p in (1, 50, 90, 99, 100)], h.snapshot(),
            empty.snapshot())


@scenario
def metrics_absorb_and_merged_snapshot(P):
    a = P.obs.Observability()
    b = P.obs.Observability()
    a.metrics.counter("t.n").inc(2)
    b.metrics.counter("t.n").inc(3)
    a.metrics.histogram("t.h").observe(5)
    b.metrics.histogram("t.h").observe(7)
    merged = P.metrics.Metrics()
    merged.absorb(a.metrics)
    merged.absorb(b.metrics)
    assert merged.counter("t.n").value == 5
    assert merged.histogram("t.h").count == 2
    assert merged.histogram("t.h").sum == 12
    # the process-wide view sees both live hubs
    snap = P.obs.merged_snapshot()
    assert snap["counters"]["t.n"] >= 5
    return merged.snapshot(), snap["counters"]["t.n"] >= 5


@scenario
def metrics_format_procfs_lines(P):
    m = P.metrics.Metrics()
    m.counter("kv.commits").inc(3)
    m.gauge("kv.pages_free").set(17)
    m.histogram("t.lat_us").observe(12.0)
    text = m.format()
    assert "counter kv.commits 3" in text
    assert "gauge   kv.pages_free 17" in text
    assert "hist    t.lat_us count=1" in text
    return text


# ---------------------------------------------------------------------------
# tracer core + disabled-mode no-op
# ---------------------------------------------------------------------------

@scenario
def disabled_tracer_is_true_noop(P):
    calls = []

    def probe_clock():
        calls.append(1)
        return 0

    tr = P.tracer.Tracer(enabled=False, clock=probe_clock)
    assert tr.begin_span(1, "explore") is None
    assert tr.end_span(1) is False
    tr.instant(1, "fork")
    assert calls == []                 # the clock was never consulted
    assert tr.spans == [] and tr.instants == []
    return calls, tr.spans, tr.instants


@scenario
def end_span_reentrancy_guard(P):
    tr = P.tracer.Tracer(enabled=True)
    tr.begin_span(5, "explore")
    assert tr.end_span(5, status="committed") is True
    # the double close IS the subject under test here
    assert tr.end_span(5) is False  # branchlint: ignore[BL004]
    assert len(tr.spans) == 1
    assert tr.spans[0].status == "committed"
    return spans_of(tr)


@scenario
def chrome_trace_schema_valid_and_loadable(P, tmp_path):
    tr = P.tracer.Tracer(enabled=True)
    tr.begin_span(0, "explore", group=0)
    tr.begin_span(1, "explore", parent=0)
    tr.instant(1, "fork")
    tr.end_span(1, status="committed")
    path = tmp_path / "trace.json"
    tr.export_chrome_trace(path)
    loaded = json.loads(path.read_text())   # valid JSON on disk
    evs = loaded["traceEvents"]
    assert all({"ph", "name", "pid"} <= set(e) for e in evs)
    for e in evs:
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] >= 0
    # the still-open root span was flushed, not dropped
    root = [e for e in evs if e["ph"] == "X" and e["tid"] == 0]
    assert root and root[0]["args"]["status"] == "open"
    # child inherited the root's process and recorded its parent
    child = [e for e in evs if e["ph"] == "X" and e["tid"] == 1][0]
    # the deliberately-open root span is the subject under test
    assert child["pid"] == 0 and child["args"]["parent"] == 0  # branchlint: ignore[BL004]
    # everything but the clock readings
    return sorted(json.dumps({k: v for k, v in e.items()
                              if k not in ("ts", "dur")}, sort_keys=True)
                  for e in evs)


# ---------------------------------------------------------------------------
# lifecycle instrumentation (span tree mirrors branch tree)
# ---------------------------------------------------------------------------

def traced_tree(P, **kw):
    obs = P.obs.Observability(trace=True)
    return P.lifecycle.BranchTree(tracer=obs.tracer, **kw), obs.tracer


@scenario
def span_nesting_mirrors_branch_nesting(P):
    tree, tr = traced_tree(P)
    root = tree.create_root()
    a, b = tree.fork(root, 2)
    (a1,) = tree.fork(a, 1)
    lineage = tr.lineage()
    assert lineage == {root: None, a: root, b: root, a1: a}
    tree.commit(a1)
    tree.commit(a)
    by_track = {s.track: s for s in tr.spans}
    assert by_track[a1].status == "committed"
    assert by_track[a].status == "committed"
    assert by_track[b].status == "invalidated"
    assert root not in by_track          # root still open (live)
    assert tr.has_open(root)
    return lineage, spans_of(tr), instants_of(tr)


@scenario
def invalidation_events_fire_exactly_once_per_killed_sibling(P):
    tree, tr = traced_tree(P)
    root = tree.create_root()
    kids = tree.fork(root, 4)
    tree.commit(kids[0])
    for k in kids[1:]:
        assert tree.status(k) is P.lifecycle.BranchStatus.STALE
        tree.abort(k)
    inv = [i for i in tr.instants if i.name == "invalidated"]
    assert sorted(i.track for i in inv) == sorted(kids[1:])
    assert len(inv) == 3                 # exactly once each
    commits = [i for i in tr.instants if i.name == "commit"]
    assert [c.track for c in commits] == [kids[0]]
    return spans_of(tr), instants_of(tr)


@scenario
def reap_closes_purged_open_spans_as_invalidated(P):
    tree, tr = traced_tree(P)
    root = tree.create_root()
    a, b = tree.fork(root, 2)
    tree.fork(a, 2)                      # grandchildren, still open
    tree.invalidate(root, status=P.lifecycle.BranchStatus.ABORTED)
    assert tree.reap(root) == 5
    assert tr.open_spans == []           # nothing leaked
    by_track = {s.track: s for s in tr.spans}
    assert len(by_track) == 5            # nothing double-closed
    assert by_track[root].status == "aborted"
    assert all(by_track[t].status in ("invalidated", "aborted")
               for t in by_track)
    inv = [i.track for i in tr.instants if i.name == "invalidated"]
    assert len(inv) == len(set(inv))
    return spans_of(tr), instants_of(tr)


@scenario
def lazy_stale_discovery_closes_span_once(P):
    tree, tr = traced_tree(P)
    root = tree.create_root()
    a, b = tree.fork(root, 2)
    tree.commit(a)                       # b eagerly invalidated
    closes_before = len(tr.spans)
    assert tree.status(b) is P.lifecycle.BranchStatus.STALE
    assert len(tr.spans) == closes_before
    return spans_of(tr), instants_of(tr)


# ---------------------------------------------------------------------------
# engine / scheduler / session integration
# ---------------------------------------------------------------------------

@scenario
def engine_counters_are_registry_views(P):
    eng = P.engine()
    assert eng.cow_dispatches == 0       # fresh engine, fresh hub
    root = eng.add_request([7, 8, 9])
    kids = eng.fork(root, 3)
    eng.decode(kids)
    snap = eng.obs.metrics.snapshot()
    assert eng.cow_faults == snap["counters"]["engine.cow_faults"] > 0
    assert eng.cow_dispatches == snap["counters"]["engine.cow_dispatches"]
    st = eng.stats()
    for key in ("cow_dispatches", "cow_faults", "cow_inline_steps",
                "verify_dispatches", "pages_free", "pages_total"):
        assert key in st
    assert snap["histograms"]["engine.decode_step_us"]["count"] == 1
    assert snap["histograms"]["engine.batch_occupancy"]["p50"] >= 3
    assert snap["counters"]["engine.tokens_decoded"] == 3
    assert snap["gauges"]["engine.kv_pool_bytes"] > 0
    assert snap["counters"]["kv.branches_forked"] == 3
    st.pop("attn_impl")
    return (snap["counters"], snap["gauges"],
            snap["histograms"]["engine.batch_occupancy"], st)


@scenario
def kv_footprints_and_pool_gauges(P):
    eng = P.engine()
    root = eng.add_request([1, 2, 3, 4, 5])
    fp = eng.kv.footprints()
    assert fp[root] == len(eng.kv.block_table(root))
    kids = eng.fork(root, 2)
    fp2 = eng.kv.footprints()
    assert set(kids) <= set(fp2)
    g = eng.obs.metrics.snapshot()["gauges"]
    assert g["kv.pages_free"] == eng.kv.free_pages
    assert g["kv.pages_shared"] == eng.kv.stats()["pages_shared"]
    eng.commit(kids[0])
    g2 = eng.obs.metrics.snapshot()["gauges"]
    assert g2["kv.pages_free"] == eng.kv.free_pages
    assert g2["kv.pages_shared"] == eng.kv.stats()["pages_shared"]
    return fp, fp2, g, g2


@scenario
def session_stat_metrics_and_format_tree(P):
    eng = P.engine()
    session = P.api.BranchSession(eng, max_batch=8, seed=0)
    root = session.open([3, 1, 4], max_new_tokens=4)
    for _ in range(4):
        session.step()
    view = session.stat(metrics=True)    # the README quickstart call
    assert "metrics" in view and "branches" in view
    assert view["metrics"]["counters"]["sched.admitted"] == 1
    assert "footprints" in view
    per_hd = session.stat(root, metrics=True)
    assert per_hd["hd"] == root and "metrics" in per_hd
    text = session.format_tree(metrics=True)
    assert "metrics:" in text and "counter sched.admitted 1" in text
    assert "metrics:" not in session.format_tree()
    wait = view["metrics"]["histograms"]["sched.admission_wait_us"]
    assert wait["count"] == 1
    session.finish(root)                 # release the handle (BL002)
    counters = [ln for ln in text.splitlines()
                if ln.strip().startswith("counter ")]
    return (view["metrics"]["counters"], view["footprints"],
            sorted(view), sorted(per_hd), counters,
            session.format_tree())


@scenario
def best_of_n_trace_matches_snapshot_lineage(P, tmp_path):
    eng = P.engine(num_pages=256, obs=P.obs.Observability(trace=True))
    session = P.api.BranchSession(eng, max_batch=16, seed=3)
    driver = P.x.ExplorationDriver(session)
    exp = driver.explore([7, 3, 9, 2], max_new_tokens=9,
                         policy=P.x.best_of_n, n=8, tokens=4,
                         temperature=1.5)
    snapshot = None
    for _ in range(500):
        if not driver.step():
            break
        snap = eng.kv.tree.snapshot()
        if snap and len(snap[0].get("children", [])) == 8:
            snapshot = snap              # the full 9-node tree, mid-run
    driver.run()
    assert exp.result is not None and snapshot is not None

    path = tmp_path / "trace.json"
    trace = session.trace(path)
    loaded = json.loads(path.read_text())
    assert loaded == trace
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"
             and e["name"] == "explore"]
    inst = [e for e in trace["traceEvents"] if e["ph"] == "i"]

    def lineage_of(node, parent=None, out=None):
        out[node["id"]] = parent
        for c in node["children"]:
            lineage_of(c, node["id"], out)
        return out

    want = lineage_of(snapshot[0], None, {})
    got = {e["tid"]: e["args"].get("parent") for e in spans}
    assert got == want                   # one track per branch, exact tree
    assert len({e["tid"] for e in spans}) == 9
    committed = {e["tid"] for e in inst if e["name"] == "commit"}
    assert len(committed) == 1
    invalidated = {e["tid"] for e in inst if e["name"] == "invalidated"}
    kids = set(want) - {snapshot[0]["id"]}
    assert kids - committed <= invalidated
    from_engine = [e["name"] for e in inst
                   if e["tid"] == P.tracer.ENGINE_TRACK]
    assert "decode_step" in from_engine
    return (got, len(committed), sorted(kids - committed) == sorted(
        invalidated & kids), sorted(set(from_engine)),
        sorted({e["name"] for e in trace["traceEvents"]}))


@scenario
def untraced_engine_records_nothing(P):
    eng = P.engine()
    root = eng.add_request([5, 6])
    eng.fork(root, 2)
    assert eng.obs.tracer.spans == []
    assert eng.obs.tracer.instants == []
    return eng.obs.tracer.spans, eng.obs.tracer.instants


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_the_reference(pkgs, name, tmp_path):
    fn = SCENARIOS[name]
    records = {}
    for pkg in ("jax", "port"):
        kw = {}
        if "tmp_path" in fn.__code__.co_varnames:
            kw["tmp_path"] = tmp_path / pkg
            kw["tmp_path"].mkdir()
        records[pkg] = fn(pkgs[pkg], **kw)
    assert records["port"] == records["jax"]
