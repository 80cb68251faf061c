"""Port parity: the scheduler (admission ledger, continuous batching, fork
admission, reaping) against the JAX package's.

Each scenario of ``tests/test_scheduler.py`` runs once per package through
a namespace of that package's modules, keeps the reference test's own
asserts, and returns a record of what it saw: tokens, engine counters,
``stats()``, step records and the errno of every refusal.  The two records
must be equal.  Both engines run ``paper-agentic`` at float32 from one set
of weights (the JAX ``Model.init(PRNGKey(0))`` bridged through numpy), the
port on the CPU (its kernels' plain versions), the JAX engine with
``attn_impl="fused_ref"`` (the same fused step as the port's main path).
Greedy runs are held on tokens; the two packages draw sampling noise from
different streams, so sampled runs are held on structure: step records,
token counts and a drained pool.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro.core.errors as jax_errors
import repro.runtime.scheduler as jax_sched
import repro.runtime.serve_loop as jax_serve
import repro_torch.core as port_core
import repro_torch.core.errors as port_errors
import repro_torch.runtime.scheduler as port_sched
import repro_torch.runtime.serve_loop as port_serve
from repro.configs import get_config
from repro.models.model import Model as JaxModel
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as port_config
from repro_torch.models import Model
from torch_parity import is_port, shared_counters, shared_stats


@pytest.fixture(scope="module")
def pkgs():
    jcfg = dataclasses.replace(get_config("paper-agentic"), dtype="float32")
    pcfg = dataclasses.replace(port_config("paper-agentic"), dtype="float32")
    jmodel = JaxModel(jcfg, attn_chunk=8, remat=False)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    pparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    pmodel = Model(pcfg)

    def jax_engine(legacy=False, **kw):
        return jax_serve.ServeEngine(
            jmodel, jparams, attn_impl="ref" if legacy else "fused_ref",
            **geometry(kw))

    def port_engine(legacy=False, **kw):
        return port_serve.ServeEngine(
            pmodel, pparams, device="cpu",
            attn_impl="ref" if legacy else "auto", **geometry(kw))

    return {
        "jax": types.SimpleNamespace(
            engine=jax_engine, core=jax_core, errors=jax_errors,
            sched=jax_sched,
            seed=lambda s: {"key": jax.random.PRNGKey(s)}),
        "port": types.SimpleNamespace(
            engine=port_engine, core=port_core, errors=port_errors,
            sched=port_sched, seed=lambda s: {"generator": s}),
    }


def geometry(kw):
    kw.setdefault("num_pages", 128)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_pages_per_seq", 16)
    return kw


def refusal(fn, *args, **kw):
    """The class name and errno of the BranchError ``fn`` raises."""
    with pytest.raises(Exception) as exc:
        fn(*args, **kw)
    errno = getattr(exc.value, "errno", None)
    return type(exc.value).__name__, getattr(errno, "name", errno)


def stats(eng_or_sched):
    st = dict(eng_or_sched.stats())
    st.pop("attn_impl")
    return shared_stats(eng_or_sched, st)


def pages_for(eng, n_tokens):
    return -(-n_tokens // eng.page_size)


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------------------
# CoW fault service
# ---------------------------------------------------------------------------

@scenario
def cow_faults_serviced_in_one_step(P, legacy=False):
    eng = P.engine(legacy=legacy)
    root = eng.add_request([7, 8, 9])     # 2 cached tokens: mid-page tail
    branches = eng.fork(root, 3)
    f0 = eng.cow_faults
    out = eng.decode(branches)
    # every sibling CoW-faults the shared tail page, all in one step
    assert eng.cow_faults == f0 + 3
    counters = (eng.cow_dispatches, eng.cow_inline_steps)
    assert counters == ((1, 0) if legacy else (0, 1))
    out += eng.decode(branches)           # tails private: no more faults
    assert (eng.cow_dispatches, eng.cow_inline_steps) == counters
    return out, stats(eng)


@scenario
def cow_faults_serviced_in_one_dispatch_legacy(P):
    return cow_faults_serviced_in_one_step(P, legacy=True)


@scenario
def cow_batched_equals_unbatched_decode(P):
    prompt = [11, 22, 33]
    ctrl = P.engine()
    c = ctrl.add_request(prompt)
    want = [ctrl.decode([c])[0] for _ in range(3)]
    eng = P.engine()
    root = eng.add_request(prompt)
    b1, b2, b3 = eng.fork(root, 3)
    for _ in range(3):
        eng.decode([b1, b2, b3])
    assert eng.tokens(b1)[3:] == eng.tokens(b2)[3:] == want
    return want, stats(eng)


# ---------------------------------------------------------------------------
# admission + continuous batching + retirement
# ---------------------------------------------------------------------------

@scenario
def continuous_batching_matches_unscheduled_decode(P):
    ctrl = P.engine()
    c = ctrl.add_request([1, 2, 3])
    want = [ctrl.decode([c])[0] for _ in range(3)]
    eng = P.engine()
    sched = P.sched.Scheduler(eng, P.sched.SchedulerConfig(max_batch=4))
    r1 = sched.submit([1, 2, 3], max_new_tokens=3)
    r2 = sched.submit([9, 8, 7, 6], max_new_tokens=5)
    produced = sched.run(max_steps=20)
    assert produced == 3 + 5
    res1, res2 = sched.result(r1), sched.result(r2)
    assert res1 == [1, 2, 3] + want
    assert len(res2) == 4 + 5
    st = stats(sched)
    assert st["sequences_live"] == 0 and st["token_tails"] == 0
    assert st["pages_free"] == st["pages_total"]
    return res1, res2, st


@scenario
def admission_waits_for_page_budget(P):
    eng = P.engine(num_pages=5)
    sched = P.sched.Scheduler(eng, P.sched.SchedulerConfig(max_batch=4))
    r1 = sched.submit(list(range(1, 9)), max_new_tokens=2)
    r2 = sched.submit(list(range(11, 19)), max_new_tokens=2)
    first = sched.step()
    assert first["admitted"] == 1 and first["waiting"] == 1
    steps = [first]
    while sched.stats()["waiting"] or sched.stats()["running"]:
        steps.append(sched.step())
    res = sched.result(r1), sched.result(r2)
    assert len(res[0]) == len(res[1]) == 10
    return steps, res, stats(sched)


@scenario
def submit_refusals_carry_errno(P):
    out = []
    sched = P.sched.Scheduler(P.engine(num_pages=8))
    out.append(refusal(sched.submit, list(range(1, 9)), max_new_tokens=40))
    sched = P.sched.Scheduler(P.engine(max_pages_per_seq=4))
    out.append(refusal(sched.submit, [1, 2, 3, 4], max_new_tokens=16))
    sched = P.sched.Scheduler(P.engine(num_pages=4))
    out.append(refusal(sched.submit, list(range(100))))
    # the FIFO head is not blocked: a feasible request still flows
    rid = sched.submit([1, 2, 3], max_new_tokens=1)
    sched.run(max_steps=4)
    res = sched.result(rid)
    assert len(res) == 4
    assert all(r == ("AdmissionDenied", "ENOSPC") for r in out)
    return out, res, shared_counters(is_port(sched),
                                     sched.obs.metrics.snapshot()["counters"])


@scenario
def admitted_requests_always_complete(P):
    eng = P.engine(num_pages=4)
    sched = P.sched.Scheduler(eng)
    rids = [sched.submit([r + 1, r + 2], max_new_tokens=10)
            for r in range(3)]
    sched.run(max_steps=60)
    res = [sched.result(rid) for rid in rids]
    assert all(len(r) == 12 for r in res)
    st = stats(sched)
    assert st["pages_free"] == st["pages_total"]
    assert st["pages_reserved"] == 0
    return res, st


@scenario
def fork_admission_page_budget(P):
    eng = P.engine(num_pages=32)
    sched = P.sched.Scheduler(eng)
    rid = sched.submit(list(range(1, 9)), max_new_tokens=8)
    sched.admit()
    seq = sched.seq_of(rid)
    denied = refusal(sched.fork, seq, 20)
    assert denied == ("AdmissionDenied", "EAGAIN")
    children = sched.fork(seq, 2)
    assert set(sched.runnable()) == set(children)
    return denied, children, stats(sched)


@scenario
def scheduler_observes_kernel_commit(P):
    eng = P.engine()
    sched = P.sched.Scheduler(eng, P.sched.SchedulerConfig(max_batch=8))
    rid = sched.submit([2, 4, 6, 8], max_new_tokens=32)
    sched.admit()
    seq = sched.seq_of(rid)
    b1, b2 = sched.fork(seq, 2)
    sched.step()
    eng.commit(b1)
    assert sched.runnable() == [seq]
    sched.step()
    toks = eng.tokens(seq)
    assert len(toks) == 6
    return toks, stats(sched)


# ---------------------------------------------------------------------------
# cross-domain atomicity (store + KV + token tails)
# ---------------------------------------------------------------------------

@scenario
def raced_runtime_commit_kv_loser_strands_nothing(P):
    eng = P.engine()
    store = P.core.BranchStore({"plan": b"root"})
    runtime = P.core.BranchRuntime(store, eng.kv)
    root_ctx = P.core.root_context(store)
    seq = eng.add_request([5, 6, 7, 8, 9])
    eng.decode([seq])
    h1, h2 = runtime.create(root_ctx, 2,
                            flags=P.core.BR_STATE | P.core.BR_KV,
                            kv_seqs=[seq])
    c1, c2 = h1.kv_seqs[seq], h2.kv_seqs[seq]
    eng.decode([c1, c2])
    eng.commit(c2)
    winner_tokens = eng.tokens(seq)
    lost = refusal(runtime.commit, h1)
    assert lost == ("StaleBranchError", "ESTALE")
    st = stats(eng)
    assert st["token_tails"] == 1 and st["sequences_live"] == 1
    assert (st["pages_total"] - st["pages_free"]
            == pages_for(eng, eng.kv.length(seq)))
    assert eng.tokens(seq) == winner_tokens
    assert h1._resolved and not h1.state.is_active
    return winner_tokens, lost, st


@scenario
def raced_runtime_commits_store_decides_once(P):
    eng = P.engine()
    store = P.core.BranchStore({"plan": b"root"})
    runtime = P.core.BranchRuntime(store, eng.kv)
    root_ctx = P.core.root_context(store)
    seq = eng.add_request([1, 3, 5, 7])
    h1, h2 = runtime.create(root_ctx, 2,
                            flags=P.core.BR_STATE | P.core.BR_KV,
                            kv_seqs=[seq])
    eng.decode([h1.kv_seqs[seq], h2.kv_seqs[seq]])
    h2.state.write("plan", b"h2-wins")
    runtime.commit(h2)
    lost = refusal(runtime.commit, h1)
    assert root_ctx.read("plan") == b"h2-wins"
    st = stats(eng)
    assert st["token_tails"] == 1 and st["sequences_live"] == 1
    return lost, eng.tokens(seq), st


# ---------------------------------------------------------------------------
# transactional decode: -ENOSPC mutates nothing
# ---------------------------------------------------------------------------

@scenario
def decode_enospc_mutates_nothing(P):
    eng = P.engine(num_pages=3)
    a = eng.add_request([1, 2, 3, 4, 5])
    b = eng.add_request([6, 7, 8, 9, 10])
    toks = eng.tokens(a), eng.tokens(b)
    denied = refusal(eng.decode, [a, b])
    assert eng.kv.length(a) == 4 and eng.kv.length(b) == 4
    assert eng.kv.free_pages == 1
    assert (eng.tokens(a), eng.tokens(b)) == toks
    out = eng.decode([a])
    return denied, out, stats(eng)


@scenario
def decode_cow_rollback_on_enospc(P):
    eng = P.engine(num_pages=2)
    root = eng.add_request([1, 2, 3])
    b1, b2 = eng.fork(root, 2)
    tail = eng.kv.block_table(root)[-1]
    denied = refusal(eng.decode, [b1, b2])
    assert eng.kv.refcount(tail) == 3
    assert eng.kv.block_table(b1) == eng.kv.block_table(root)
    assert eng.kv.free_pages == 1
    assert eng.cow_dispatches == eng.cow_faults == 0
    return denied, stats(eng)


@scenario
def decode_refuses_table_overflow_without_mutation(P):
    eng = P.engine(max_pages_per_seq=1)
    seq = eng.add_request([1, 2, 3, 4])
    out = eng.decode([seq])
    toks = eng.tokens(seq)
    denied = refusal(eng.decode, [seq])
    assert denied[0] == "ValueError"
    assert eng.kv.length(seq) == 4 and eng.tokens(seq) == toks
    return out, stats(eng)


# ---------------------------------------------------------------------------
# kernel GC: resolved subtrees are reaped
# ---------------------------------------------------------------------------

@scenario
def resolved_branches_reaped_from_kernel(P):
    eng = P.engine()
    sched = P.sched.Scheduler(eng)
    rid = sched.submit([2, 4, 6, 8], max_new_tokens=4)
    sched.admit()
    seq = sched.seq_of(rid)
    b1, _ = sched.fork(seq, 2)
    sched.step()
    eng.commit(b1)
    sched.run(max_steps=10)
    res = sched.result(rid)
    assert res
    assert len(eng.kv.tree) == 0 and len(eng.token_domain) == 0
    assert eng.kv._tables == {} and eng.kv._lengths == {}
    assert sched._requests == {} and sched._results == {}
    again = refusal(sched.result, rid)
    return res, again, stats(sched)


@scenario
def abort_of_tracked_subtree_observed_not_crashed(P):
    eng = P.engine()
    sched = P.sched.Scheduler(eng)
    rid = sched.submit([1, 2, 3, 4], max_new_tokens=8)
    sched.admit()
    root = sched.seq_of(rid)
    (b,) = sched.fork(root, 1)
    sched.fork(b, 2)
    sched.step()
    eng.abort(b)
    sched.step()
    assert sched.runnable() == [root]
    sched.run(max_steps=20)
    res = sched.result(rid)
    assert len(res) == 12
    return res, stats(sched)


@scenario
def external_release_of_scheduled_request(P):
    eng = P.engine()
    sched = P.sched.Scheduler(eng)
    rid = sched.submit([1, 2, 3, 4], max_new_tokens=8)
    r2 = sched.submit([5, 6, 7], max_new_tokens=2)
    sched.admit()
    eng.release(sched.seq_of(rid))
    sched.run(max_steps=10)
    res = sched.result(r2)
    assert len(res) == 5
    assert sched._requests == {} and sched._seq_owner == {}
    return res, refusal(sched.result, rid), stats(sched)


@scenario
def release_reaps_whole_subtree(P):
    eng = P.engine()
    root = eng.add_request([1, 2, 3, 4, 5])
    b1, b2 = eng.fork(root, 2)
    out = eng.decode([b1, b2])
    eng.release(root)
    st = stats(eng)
    assert st["pages_free"] == st["pages_total"] and len(eng.kv.tree) == 0
    return out, st


# ---------------------------------------------------------------------------
# pacing, completion primitives, per-sequence sampling
# ---------------------------------------------------------------------------

@scenario
def finish_retires_early_and_frees(P):
    sched = P.sched.Scheduler(P.engine())
    rid = sched.submit([1, 2, 3], max_new_tokens=12)
    sched.admit()
    sched.step()
    assert not sched.finished(rid)
    sched.finish(rid)
    assert sched.finished(rid)
    res = sched.result(rid)
    assert len(res) == 4
    st = stats(sched)
    assert st["pages_free"] == st["pages_total"] and st["pages_reserved"] == 0
    return res, st


@scenario
def finish_cancels_waiting_request(P):
    sched = P.sched.Scheduler(P.engine(num_pages=4))
    r1 = sched.submit([1, 2, 3, 4], max_new_tokens=6)
    r2 = sched.submit([5, 6, 7, 8], max_new_tokens=6)
    sched.admit()
    sched.finish(r2)
    assert sched.result(r2) == []
    return sched.wait(r1, max_steps=20), stats(sched)


@scenario
def hold_blocks_decode_and_retire(P):
    sched = P.sched.Scheduler(P.engine())
    rid = sched.submit([1, 2, 3], max_new_tokens=2)
    sched.admit()
    seq = sched.seq_of(rid)
    sched.hold(seq)
    steps = [sched.step() for _ in range(3)]
    assert all(st["decoded"] == 0 and st["retired"] == 0 for st in steps)
    sched.unhold(seq)
    res = sched.wait(rid, max_steps=10)
    assert len(res) == 5
    return steps, res, stats(sched)


@scenario
def sampled_continuous_batching_drains(P):
    """Sampled rows mixed with greedy ones under continuous batching:
    held on structure (the streams differ), the greedy request on tokens."""
    eng = P.engine()
    sched = P.sched.Scheduler(eng, P.sched.SchedulerConfig(max_batch=3,
                                                           seed=5))
    greedy = sched.submit([4, 5, 6], max_new_tokens=5)
    sampled = [sched.submit([i, i + 1, i + 2], max_new_tokens=3 + i)
               for i in range(1, 5)]
    sched.admit()
    for rid in sampled:
        sched.set_sampling(sched.seq_of(rid), greedy=False, temperature=2.0)
    kids = sched.fork(sched.seq_of(sampled[0]), 2)   # inherit sampling
    steps = [sched.step(greedy=True, **P.seed(9)) for _ in range(2)]
    sched.engine.commit(kids[1])    # the origin resumes and can retire
    while sched.stats()["running"] or sched.stats()["waiting"]:
        steps.append(sched.step(greedy=True, **P.seed(9 + len(steps))))
        assert len(steps) < 40
    res = [len(sched.result(r)) for r in sampled]
    st = stats(sched)
    assert st["pages_free"] == st["pages_total"] and st["pages_reserved"] == 0
    return steps, sched.result(greedy), res, st


@scenario
def sampled_run_with_caller_seed(P):
    eng = P.engine()
    sched = P.sched.Scheduler(eng)
    rids = [sched.submit([i, 9, i], max_new_tokens=4) for i in range(3)]
    produced = sched.run(greedy=False, temperature=1.5, **P.seed(3))
    res = [sched.result(r) for r in rids]
    assert produced == 12 and all(len(r) == 7 for r in res)
    st = stats(sched)
    assert st["pages_free"] == st["pages_total"]
    return produced, [len(r) for r in res], st


@scenario
def per_seq_sampling_inherited_on_fork(P):
    sched = P.sched.Scheduler(P.engine(), P.sched.SchedulerConfig(seed=5))
    rid = sched.submit([1, 2, 3], max_new_tokens=6)
    sched.admit()
    seq = sched.seq_of(rid)
    sched.set_sampling(seq, greedy=False, temperature=2.0)
    kids = sched.fork(seq, 2)
    assert all(sched._sampling[k] == (False, 2.0) for k in kids)
    st = sched.step()
    assert all(sched.produced(k) == 1 for k in kids)
    return st, stats(sched)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_the_reference(pkgs, name):
    want = SCENARIOS[name](pkgs["jax"])
    got = SCENARIOS[name](pkgs["port"])
    assert got == want


# ---------------------------------------------------------------------------
# the port's sampling stream (no JAX counterpart: a torch.Generator)
# ---------------------------------------------------------------------------

def sampled_tokens(P, *, seed=None, config_seed=0, reseed=None):
    sched = P.sched.Scheduler(P.engine(),
                              P.sched.SchedulerConfig(seed=config_seed))
    rids = [sched.submit([i, 9, i], max_new_tokens=4) for i in range(3)]
    if reseed is not None:
        sched.seed_sampling(reseed)
    kw = {} if seed is None else {"generator": seed}
    sched.run(greedy=False, temperature=1.5, **kw)
    return [sched.result(r) for r in rids]


def test_caller_generator_reseeds_the_stream_once(pkgs):
    P = pkgs["port"]
    a = sampled_tokens(P, seed=7)
    # run(generator=) is seed_sampling() then run(): one stream for all
    # steps, not the caller's seed handed to every step
    assert sampled_tokens(P, reseed=7) == a
    assert sampled_tokens(P, seed=torch.Generator().manual_seed(7)) == a
    assert sampled_tokens(P, config_seed=7) == a
    assert sampled_tokens(P, seed=8) != a


def test_scheduler_generator_lives_on_the_engine_device(pkgs):
    P = pkgs["port"]
    sched = P.sched.Scheduler(P.engine())
    assert sched._generator.device == sched.engine.device
    # an engine on the card refuses a host generator (checked before any
    # draw, so no card is needed to see it)
    sched.engine.device = torch.device("cuda")
    with pytest.raises(ValueError, match="share a device"):
        sched.seed_sampling(torch.Generator())
    with pytest.raises(ValueError, match="share a device"):
        sched.step(generator=torch.Generator())
