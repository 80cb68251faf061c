"""Port parity: the exploration layer (``explore_ctx``: contexts, the
event-driven driver, ``best_of_n``/``beam_search``/``tree_search`` and
``speculative_decode``) against the JAX package's.

Each scenario of ``tests/test_explore_ctx.py`` runs once per package
through a namespace of that package's modules, keeps the reference test's
own asserts, and returns a record that must be equal across the two.  The
built-in policies sample at temperature 1.5, and the two packages draw
from different random streams, so a policy run is held on structure:
commits, ``degraded`` flags, levels, branch and score counts, generated
lengths, driver rounds and a drained pool.  Policies that decode greedily,
and ``spec_verify``'s target rows for the same drafts, are held on tokens.
Both engines run ``paper-agentic`` at float32 from one set of weights, the
port on the CPU, the JAX engine on its fused path.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest

import repro.api as jax_api
import repro.core as jax_core
import repro.explore_ctx as jax_explore
import repro.runtime.scheduler as jax_sched
import repro.runtime.serve_loop as jax_serve
import repro_torch.api as port_api
import repro_torch.core as port_core
import repro_torch.explore_ctx as port_explore
import repro_torch.runtime.scheduler as port_sched
import repro_torch.runtime.serve_loop as port_serve
from repro.configs import get_config
from repro.models.model import Model as JaxModel
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as port_config
from repro_torch.models import Model
from torch_parity import shared_stats


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
            api=jax_api, core=jax_core, x=jax_explore, sched=jax_sched,
            engine=lambda **kw: jax_serve.ServeEngine(
                jmodel, jparams, attn_impl="fused_ref", **geometry(kw))),
        "port": types.SimpleNamespace(
            api=port_api, core=port_core, x=port_explore, sched=port_sched,
            engine=lambda **kw: port_serve.ServeEngine(
                pmodel, pparams, device="cpu", **geometry(kw))),
    }


def geometry(kw):
    kw.setdefault("num_pages", 128)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_pages_per_seq", 16)
    return kw


def fresh_driver(P, *, store=None, **kw):
    eng = P.engine(**kw)
    sched = P.sched.Scheduler(eng, P.sched.SchedulerConfig(max_batch=8,
                                                           seed=3))
    return eng, sched, P.x.ExplorationDriver(sched, store=store)


def drained(sched):
    st = sched.stats()
    assert st["pages_free"] == st["pages_total"]
    assert st["pages_reserved"] == 0
    assert st["running"] == 0 and st["held"] == 0
    assert st["token_tails"] == 0
    assert len(sched.engine.kv.tree) == 0
    st.pop("attn_impl")
    return shared_stats(sched, st)


def refusal(fn, *args, **kw):
    with pytest.raises(Exception) as exc:
        fn(*args, **kw)
    errno = getattr(exc.value, "errno", None)
    return type(exc.value).__name__, getattr(errno, "name", errno)


def shape(res):
    """What a sampled policy run must share across packages: everything
    but token values and the scores computed from them."""
    stats = {}
    for k, v in res.stats.items():
        if k in ("scores", "verified_per_draft"):
            v = len(v)
        elif k == "levels":
            v = [{kk: (len(vv) if kk == "scores" else vv)
                  for kk, vv in lv.items() if kk != "winner_seq"}
                 for lv in v]
        elif k == "winner_depth":
            v = "winner_depth"           # which node wins follows scores
        stats[k] = v
    return res.committed, len(res.generated), stats


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------------------
# policies end-to-end through admission (sampled: held on structure)
# ---------------------------------------------------------------------------

@scenario
def best_of_n_end_to_end(P):
    eng, sched, drv = fresh_driver(P)
    exp = drv.explore([7, 3, 9], 8, P.x.best_of_n, n=3, tokens=4)
    res = exp.run()
    assert res.committed and len(res.generated) == 4
    assert res.stats["branches"] == 3
    assert res.score == max(res.stats["scores"])
    assert exp.final_tokens == res.tokens
    return shape(res), drv.steps, drained(sched)["steps"]


@scenario
def beam_search_commits_per_level(P):
    eng, sched, drv = fresh_driver(P)
    res = drv.explore([5, 5, 5], 9, P.x.beam_search, width=2, depth=2,
                      tokens_per_level=4).run()
    assert len(res.generated) == 8
    assert all(len(lv["scores"]) == 2 for lv in res.stats["levels"])
    return shape(res), drv.steps, drained(sched)["steps"]


@scenario
def tree_search_nested_expansion(P):
    eng, sched, drv = fresh_driver(P)
    res = drv.explore([2, 4, 6], 13, P.x.tree_search, fan_out=2,
                      max_nodes=6, tokens_per_node=3, max_depth=3).run()
    assert res.committed and res.stats["branches_created"] == 6
    depth = res.stats["winner_depth"]
    assert 1 <= depth <= 3 and len(res.generated) == 3 * depth
    drained(sched)
    return res.committed, res.stats["branches_created"], res.stats["pruned"]


@scenario
def tree_search_early_abort_prunes(P):
    eng, sched, drv = fresh_driver(P)
    res = drv.explore([2, 4, 6], 13, P.x.tree_search, fan_out=3,
                      max_nodes=6, tokens_per_node=3, prune_below=1e9).run()
    assert not res.committed and res.generated == []
    assert res.stats["pruned"] == res.stats["branches_created"]
    return shape(res), res.tokens, drv.steps, drained(sched)


@scenario
def speculative_decode_verified_prefix(P):
    eng, sched, drv = fresh_driver(P)
    res = drv.explore([9, 8, 7], 10, P.x.speculative_decode, n_drafts=2,
                      draft_tokens=5, temperature=2.0).run()
    accepted = res.stats["accepted"]
    assert 0 <= accepted <= 5
    if res.stats["fallback"]:
        assert accepted == 0 and len(res.generated) == 1
    else:
        assert len(res.generated) == accepted
        assert res.stats["verify_dispatches"] == 1
        assert eng.verify_dispatches == 1
    assert res.stats["acceptance_rate"] == accepted / 5
    drained(sched)
    m = eng.obs.metrics.snapshot()["counters"]
    return m["spec.rounds"], m["spec.tokens_proposed"], eng.verify_dispatches


@scenario
def greedy_drafts_verify_on_tokens(P):
    """The speculative shape with greedy drafts and fixed extra drafts:
    every decoded token and every verify row is held exactly."""
    eng, sched, drv = fresh_driver(P)
    seen = {}

    def policy(ctx):
        kids = yield P.x.Fork(ctx, 3, flags=P.api.BR_SPECULATIVE)
        yield P.x.Decode(kids[1:], 6, greedy=True)
        rows = [k.generated() for k in kids[1:]]
        drafts = rows + [[1, 2, 3, 4, 5, 6], rows[0][:3] + [0, 0, 0]]
        seen["rows"] = ctx.verify(drafts)
        seen["lcp"] = [P.x.lcp_len(d, r) for d, r in zip(drafts,
                                                          seen["rows"])]
        kids[1].truncate(4)
        kids[1].commit()
        return ctx.tokens()

    toks = drv.explore([9, 8, 7, 6, 5], 12, policy).run()
    assert seen["rows"][0] == seen["rows"][1]      # greedy drafts agree
    assert seen["lcp"][:2] == [6, 6]
    return toks, seen, eng.verify_dispatches, drv.steps, drained(sched)


# ---------------------------------------------------------------------------
# concurrency: interleaved explorations, backpressure
# ---------------------------------------------------------------------------

@scenario
def interleaved_exploration_stress(P):
    eng, sched, drv = fresh_driver(P, num_pages=96)
    exps = []
    for i in range(9):
        if i % 3 == 0:
            exps.append(drv.explore([i + 1, i + 2], 8, P.x.best_of_n,
                                    n=3, tokens=4))
        elif i % 3 == 1:
            exps.append(drv.explore([i + 1, i + 2], 9, P.x.beam_search,
                                    width=2, depth=2, tokens_per_level=4))
        else:
            exps.append(drv.explore([i + 1, i + 2], 10, P.x.tree_search,
                                    fan_out=2, max_nodes=4,
                                    tokens_per_node=3))
    drv.run()
    assert all(e.done and e.error is None for e in exps)
    assert all(e.result.generated for e in exps)
    assert drv.steps < 40
    drained(sched)
    return [(e.result.committed, e.result.stats.get("branches"),
             len(e.result.stats.get("levels", ())),
             e.result.stats.get("branches_created")) for e in exps]


@scenario
def backpressure_degrades_not_crashes(P):
    eng, sched, drv = fresh_driver(P, num_pages=40)
    exps = [drv.explore([i + 1, i + 2, i + 3], 12, P.x.best_of_n, n=3,
                        tokens=4) for i in range(8)]
    drv.run()
    assert all(e.done and e.error is None for e in exps)
    degraded = [bool(e.result.stats.get("degraded")) for e in exps]
    committed = [e.result.committed for e in exps]
    assert all(d != c for d, c in zip(degraded, committed))
    assert any(committed)
    return [shape(e.result) for e in exps], drv.steps, drained(sched)


@scenario
def beam_survives_budget_exhausted_degraded_root(P):
    eng, sched, drv = fresh_driver(P, num_pages=6)
    res = drv.explore([1, 2, 3], 8, P.x.beam_search, width=2, depth=3,
                      tokens_per_level=4).run()
    assert any(lv.get("degraded") for lv in res.stats["levels"])
    assert len(res.stats["levels"]) == 3 and len(res.generated) == 8
    return shape(res), drv.steps, drained(sched)


# ---------------------------------------------------------------------------
# the driver's own contract (greedy or no decoding: held on tokens)
# ---------------------------------------------------------------------------

@scenario
def root_decode_to_exact_budget(P):
    eng, sched, drv = fresh_driver(P)

    def to_the_brim(ctx):
        yield P.x.Decode([ctx], 6, greedy=True)
        return ctx.tokens()

    exp = drv.explore([3, 1, 4], 6, to_the_brim)
    toks = exp.run()
    assert len(toks) == 3 + 6 and exp.final_tokens == toks
    return toks, drv.steps, drained(sched)


@scenario
def error_scoped_to_awaited_exploration(P):
    eng, sched, drv = fresh_driver(P)

    def buggy(ctx):
        raise ValueError("boom")
        yield  # pragma: no cover

    def fine(ctx):
        kids = yield P.x.Fork(ctx, 2)
        yield P.x.Decode(kids, 2, greedy=True)
        kids[0].commit()
        return ctx.tokens()

    bad = drv.explore([1, 2, 3], 8, buggy)
    good = drv.explore([4, 5, 6], 8, fine)
    toks = good.run()
    err = refusal(bad.run)
    drv.run()
    return toks, err, drained(sched)


@scenario
def no_stray_root_token_before_policy(P):
    eng, sched, drv = fresh_driver(P)
    seen = {}

    def probe(ctx):
        seen["fork_len"] = ctx.fork_len
        seen["tokens"] = ctx.tokens()
        return True
        yield  # pragma: no cover

    drv.explore([7, 3, 9], 8, probe).run()
    assert seen == {"fork_len": 3, "tokens": [7, 3, 9]}
    return seen


@scenario
def tick_wait_is_not_a_stall(P):
    eng, sched, drv = fresh_driver(P)

    def patient(ctx):
        yield P.x.Tick(4)
        return "waited"

    assert drv.explore([1, 2, 3], 8, patient).run() == "waited"
    return drv.steps


@scenario
def driver_stall_is_detected(P):
    eng, sched, drv = fresh_driver(P)

    def bad_policy(ctx):
        yield P.x.Fork(ctx, 2)
        yield P.x.Decode([ctx], 4)

    drv.explore([1, 2, 3], 8, bad_policy)
    err = refusal(drv.run)
    assert err == ("BranchError", "EBUSY")
    return err, drv.steps


@scenario
def nested_context_abort_invalidates_grandchildren(P):
    eng, sched, drv = fresh_driver(P)
    holder = {}

    def nested(ctx):
        (child,) = yield P.x.Fork(ctx, 1)
        grandkids = yield P.x.Fork(child, 2)
        yield P.x.Decode(grandkids, 2, greedy=True)
        holder["gen"] = [g.generated() for g in grandkids]
        child.abort()
        holder["alive"] = [c.alive for c in [child] + grandkids]
        return ctx.generated()

    out = drv.explore([4, 5, 6], 8, nested).run()
    assert holder["alive"] == [False, False, False]
    return out, holder, drained(sched)


@scenario
def nested_composite_abort_spans_store_domain(P):
    store = P.core.BranchStore({"plan": b"root"})
    eng, sched, drv = fresh_driver(P, store=store)
    holder = {}

    def nested(ctx):
        (child,) = yield P.x.Fork(ctx, 1)
        grandkids = yield P.x.Fork(child, 2)
        yield P.x.Decode(grandkids, 2, greedy=True)
        for i, g in enumerate(grandkids):
            g.state.write("plan", f"g{i}".encode())
        child.abort()
        holder["kv_dead"] = [not c.alive for c in [child] + grandkids]
        holder["state"] = [c.state.status.value
                           for c in [child] + grandkids]
        return True

    drv.explore([4, 5, 6], 8, nested).run()
    assert holder["kv_dead"] == [True, True, True]
    assert store.read(P.core.BranchStore.ROOT, "plan") == b"root"
    assert len(store._tree) == 1
    return holder, drained(sched)


@scenario
def composite_commit_promotes_both_domains(P):
    store = P.core.BranchStore({"plan": b"root"})
    eng, sched, drv = fresh_driver(P, store=store)

    def pick_one(ctx):
        kids = yield P.x.Fork(ctx, 3)
        yield P.x.Decode(kids, 3, greedy=True)
        for i, k in enumerate(kids):
            k.state.write("plan", f"branch-{i}".encode())
        kids[2].commit()
        return ctx.state.read("plan"), ctx.tokens()

    res = drv.explore([1, 2, 3], 8, pick_one).run()
    assert res[0] == b"branch-2"
    return res, drained(sched)


@scenario
def composite_fork_backpressure_does_not_churn_store(P):
    store = P.core.BranchStore({"plan": b"root"})
    eng, sched, drv = fresh_driver(P, store=store, num_pages=4)
    rid = sched.submit([1, 2, 3], max_new_tokens=4, hold=True)
    sched.admit()
    ctx = drv._bind_root(rid, sched.seq_of(rid))
    nodes_before = len(store._tree)
    errs = [refusal(ctx.fork, 8) for _ in range(5)]
    assert len(store._tree) == nodes_before
    assert all(e == ("AdmissionDenied", "EAGAIN") for e in errs)
    return errs


@scenario
def decode_per_context_sampling_rows(P):
    eng, sched, drv = fresh_driver(P)
    seen = {}

    def mixed(ctx):
        kids = yield P.x.Fork(ctx, 3)
        yield P.x.Decode(kids, 3, greedy=[True, False, False],
                         temperature=[1.0, 3.0, 3.0])
        seen["greedy_lane"] = kids[0].generated()
        seen["lens"] = [len(k.generated()) for k in kids]
        try:
            yield P.x.Decode(kids, 1, greedy=[True])
        except ValueError as err:
            seen["bad_rows"] = str(err)
        kids[0].commit()
        return ctx.tokens()

    toks = drv.explore([11, 12, 13], 8, mixed).run()
    assert seen["lens"] == [3, 3, 3]
    return toks, seen, drained(sched)


@scenario
def admission_error_reaches_policy(P):
    eng, sched, drv = fresh_driver(P, num_pages=4)

    def wants_too_much(_):
        try:
            yield P.x.Submit(list(range(100)), 100)
        except P.core.BranchError as err:
            return type(err).__name__, err.errno.name

    exp = drv.launch(wants_too_much(None))
    drv.run()
    assert exp.result == ("AdmissionDenied", "ENOSPC")
    return exp.result


@scenario
def truncate_then_commit_keeps_prefix(P):
    eng = P.engine()
    root = eng.add_request([1, 2, 3, 4, 5])
    b1, b2 = eng.fork(root, 2)
    for _ in range(6):
        eng.decode([b1, b2])
    assert P.x.lcp_len(eng.tokens(b1)[5:], eng.tokens(b2)[5:]) == 6
    free_before = eng.kv.free_pages
    eng.truncate(b1, 5 + 2)
    kept = eng.tokens(b1)
    assert kept == eng.tokens(b2)[:7] and eng.kv.length(b1) == 6
    assert eng.kv.free_pages > free_before
    eng.commit(b1)
    assert eng.tokens(root) == kept
    eng.decode([root])
    out = eng.tokens(root)
    eng.release(root)
    assert eng.kv.free_pages == eng.kv.num_pages
    return out, refusal(eng.truncate, root, 9)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_the_reference(pkgs, name):
    want = SCENARIOS[name](pkgs["jax"])
    got = SCENARIOS[name](pkgs["port"])
    assert got == want


def test_driver_reseeds_from_a_caller_generator(pkgs):
    """``run(generator=)`` reseeds the scheduler's stream once (the JAX
    driver's ``key=``): the same seed gives the same sampled exploration,
    a different one another."""
    P = pkgs["port"]

    def once(seed):
        eng, sched, drv = fresh_driver(P)
        exps = [drv.explore([i, 2, 3], 8, P.x.best_of_n, n=3, tokens=4)
                for i in range(1, 4)]
        drv.run(generator=seed)
        drained(sched)
        return [e.result.tokens for e in exps]

    assert once(5) == once(5)
    assert once(5) != once(6)
