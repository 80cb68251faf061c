"""Port parity: ``BranchSession`` (``repro_torch.api``) against the JAX
package's ``repro.api`` — errno discipline, the flags word, the handle
table, vectorized fork and unified eventing.

Each scenario of ``tests/test_api.py`` runs once per package through a
namespace of that package's modules, keeps the reference test's own
asserts, and returns a record — handles, tokens, engine counters,
``stat()``/``tree()`` views and the class and errno of every refusal —
that must be equal across the two.  A seeded random storm of
open/branch/commit/abort/truncate/step/finish/close ops then runs op for
op in both packages: the same results and the same errnos at every op,
and a drained pool with no open handle at the end.  Both engines run
``paper-agentic`` at float32 from one set of weights, the port on the CPU,
the JAX engine on its fused path (``attn_impl="fused_ref"``); every
session step here is greedy, so tokens are held exactly.
"""

import dataclasses
import threading
import time
import types

import jax
import numpy as np
import pytest

import repro.api as jax_api
import repro.core as jax_core
import repro.runtime.serve_loop as jax_serve
import repro_torch.api as port_api
import repro_torch.core as port_core
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
            api=jax_api, core=jax_core,
            engine=lambda **kw: jax_serve.ServeEngine(
                jmodel, jparams, attn_impl="fused_ref", **geometry(kw))),
        "port": types.SimpleNamespace(
            api=port_api, core=port_core,
            engine=lambda **kw: port_serve.ServeEngine(
                pmodel, pparams, device="cpu", **geometry(kw))),
    }


def geometry(kw):
    kw.setdefault("num_pages", 128)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_pages_per_seq", 16)
    return kw


def session(P, *, store=None, **kw):
    return P.api.BranchSession(P.engine(**kw), store=store, max_batch=8,
                               seed=11)


def opened_root(P, s, prompt=(1, 2, 3), max_new_tokens=12, flags=0):
    hd = s.open(list(prompt), max_new_tokens, flags)
    assert s.admitted(hd)
    return hd


def refusal(fn, *args, **kw):
    """The class name and errno of what ``fn`` raises."""
    with pytest.raises(Exception) as exc:
        fn(*args, **kw)
    errno = getattr(exc.value, "errno", None)
    return type(exc.value).__name__, getattr(errno, "name", errno)


def counters(s):
    e = s.engine
    return (e.cow_dispatches, e.cow_faults, e.cow_inline_steps,
            e.verify_dispatches, e.prefill_dispatches)


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------------------
# errno discipline + handle table
# ---------------------------------------------------------------------------

@scenario
def every_branch_error_carries_shared_errno(P):
    a = P.api
    out = [a.AdmissionDenied("x").errno.name,
           a.AdmissionDenied("x", errno=a.Errno.ENOSPC).errno.name,
           a.StaleBranchError("x").errno.name,
           a.BadHandleError("x").errno.name,
           a.BranchStateError("x").errno.name,
           a.PoolExhausted("x").errno.name]
    assert isinstance(a.PoolExhausted("x"), MemoryError)
    assert isinstance(a.PoolExhausted("x"), a.BranchError)
    return out, {e.name: e.value for e in a.Errno}


@scenario
def never_fitting_request_is_enospc_not_eagain(P):
    s = session(P, num_pages=4)
    err = refusal(s.open, list(range(100)), max_new_tokens=100)
    assert err == ("AdmissionDenied", "ENOSPC")
    return err


@scenario
def closed_handle_is_ebadf(P):
    s = session(P)
    root = opened_root(P, s)
    s.close(root)
    errs = [refusal(op, root)
            for op in (s.stat, s.events, s.tokens, s.abort, s.siblings)]
    assert all(e == ("BadHandleError", "EBADF") for e in errs)
    return root, errs


@scenario
def recycled_slot_does_not_alias_old_handle(P):
    s = session(P)
    a = opened_root(P, s, prompt=(1, 2, 3))
    toks = s.finish(a)
    b = opened_root(P, s, prompt=(4, 5, 6))
    assert (a >> 16) == (b >> 16) and a != b
    err = refusal(s.stat, a)
    return a, b, toks, err, s.stat(b)


@scenario
def finish_closes_the_whole_subtree(P):
    s = session(P)
    root = opened_root(P, s, flags=P.api.BR_HOLD)
    kids = s.branch(root, P.api.BR_HOLD, 2)
    s.finish(root)
    errs = [refusal(s.events, hd) for hd in [root] + kids]
    view = s.tree()
    assert view["pool"]["pages_free"] == view["pool"]["pages_total"]
    assert view["handles"]["open"] == 0
    return kids, errs, view


# ---------------------------------------------------------------------------
# flags word
# ---------------------------------------------------------------------------

@scenario
def nonblock_and_blocking_fork_under_pressure(P):
    s = session(P, num_pages=8)
    root = opened_root(P, s, max_new_tokens=8, flags=P.api.BR_HOLD)
    steps = s.steps
    nonblock = refusal(s.branch, root, P.api.BR_NONBLOCK, 8)
    assert nonblock == ("AdmissionDenied", "EAGAIN") and s.steps == steps
    blocking = refusal(s.branch, root, 0, 8)
    assert s.steps > steps               # it let work drain first
    return nonblock, blocking, s.steps, s.tree()


@scenario
def isolate_rejects_sibling_access_at_handle_table(P):
    s = session(P)
    root = opened_root(P, s, flags=P.api.BR_HOLD)
    iso = s.branch(root, P.api.BR_ISOLATE | P.api.BR_HOLD, 2)
    err = refusal(s.siblings, iso[0])
    assert err == ("BranchError", "EPERM")
    kids = s.branch(iso[0], P.api.BR_HOLD | P.api.BR_NESTED, 2)
    assert set(s.siblings(kids[0])) == set(kids)
    return iso, err, kids, s.stat(kids[1])


@scenario
def nested_fork_requires_br_nested(P):
    s = session(P)
    root = opened_root(P, s, flags=P.api.BR_HOLD)
    (kid,) = s.branch(root, P.api.BR_HOLD, 1)
    err = refusal(s.branch, kid, P.api.BR_HOLD, 2)
    assert err == ("BranchError", "EINVAL")
    grandkids = s.branch(kid, P.api.BR_HOLD | P.api.BR_NESTED, 2)
    return err, grandkids, s.tree()


@scenario
def truncate_requires_br_speculative(P):
    s = session(P)
    root = opened_root(P, s, flags=P.api.BR_HOLD)
    (plain,) = s.branch(root, 0, 1)
    (draft,) = s.branch(root, P.api.BR_SPECULATIVE, 1)
    ready = s.wait([plain, draft], produced=3, require_all=True)
    err = refusal(s.truncate, plain, 1)
    assert err == ("BranchError", "EPERM")
    s.truncate(draft, 1)
    assert len(s.tokens(draft)) == len(s.tokens(root)) + 1
    return ready, err, s.tokens(plain), s.tokens(draft), counters(s)


# ---------------------------------------------------------------------------
# unified eventing
# ---------------------------------------------------------------------------

@scenario
def first_commit_wins_invalidation_observed_through_poll(P):
    s = session(P)
    root = opened_root(P, s, flags=P.api.BR_HOLD)
    kids = s.branch(root, 0, 3)
    s.wait(kids, produced=2, require_all=True)
    assert s.poll(kids) == {}
    s.commit(kids[1])
    ready = s.poll(kids)
    assert ready[kids[1]] & P.api.EV_COMMITTED
    assert ready[kids[0]] & ready[kids[2]] & P.api.EV_INVALIDATED
    assert not s.alive(kids[0]) and not s.alive(kids[2])
    err = refusal(s.commit, kids[2])
    return ready, err, s.tokens(root), [s.stat(k) for k in kids]


@scenario
def waiter_finished_event_and_result(P):
    s = session(P)
    root = s.open([5, 6, 7], max_new_tokens=4)
    ready = P.api.Waiter(s).add(root, P.api.EV_FINISHED).wait(
        timeout_steps=50)
    assert ready[root] & P.api.EV_FINISHED
    toks = s.result(root)
    assert len(toks) == 3 + 4
    assert s.finish(root) == toks and s.finish(root) is None
    return ready, toks, s.steps


@scenario
def admission_event_fires_when_fifo_drains(P):
    s = session(P, num_pages=8)
    first = s.open([1, 2, 3], max_new_tokens=17)
    second = s.open([4, 5, 6], max_new_tokens=17)
    assert not s.events(second) & P.api.EV_ADMITTED
    ready = s.wait([second], events=P.api.EV_ADMITTED, timeout_steps=100)
    assert ready[second] & P.api.EV_ADMITTED
    return ready, s.steps, s.finish(first), s.finish(second)


@scenario
def branch_sees_admission_that_happened_during_steps(P):
    s = session(P, num_pages=8)
    first = s.open([1, 2, 3], max_new_tokens=17)
    second = s.open([4, 5, 6], max_new_tokens=5, flags=P.api.BR_HOLD)
    while not s.sched.finished(s.req_id_of(first)):
        s.step()
    kids = s.branch(second, P.api.BR_HOLD, 2)
    assert len(kids) == 2
    return kids, s.result(first), s.finish(second)


@scenario
def branch_after_request_finished_is_clean_einval(P):
    s = session(P)
    root = s.open([1, 2, 3], max_new_tokens=3)
    s.wait([root], events=P.api.EV_FINISHED, timeout_steps=50)
    err = refusal(s.branch, root, P.api.BR_HOLD, 2)
    assert err == ("BranchStateError", "EINVAL")
    return err, s.result(root)


@scenario
def finish_through_child_handle_claims_result(P):
    s = session(P)
    root = opened_root(P, s, flags=P.api.BR_HOLD)
    (kid,) = s.branch(root, 0, 1)
    s.wait([kid], produced=2, require_all=True)
    s.commit(kid)
    toks = s.finish(kid)
    assert toks is not None and toks[:3] == [1, 2, 3]
    assert s.sched._results == {}
    return toks


# ---------------------------------------------------------------------------
# vectorized fork
# ---------------------------------------------------------------------------

@scenario
def vectorized_fork_single_cow_dispatch(P):
    s = session(P)
    root = opened_root(P, s, flags=P.api.BR_HOLD)
    d0, f0 = s.engine.cow_dispatches, s.engine.cow_faults
    kids = s.branch(root, 0, 4)
    assert s.engine.cow_dispatches == d0 + 1
    assert s.engine.cow_faults == f0 + 4
    s.wait(kids, produced=2, require_all=True)
    assert s.engine.cow_dispatches == d0 + 1
    return [s.tokens(k) for k in kids], counters(s)


@scenario
def sequential_forks_pay_one_dispatch_each(P):
    s = session(P)
    root = opened_root(P, s, flags=P.api.BR_HOLD)
    for _ in range(3):
        s.branch(root, P.api.BR_HOLD, 1)
    assert s.engine.cow_dispatches == 3
    return counters(s), s.tree()


@scenario
def vectorized_fork_one_ledger_group(P):
    s = session(P)
    root = opened_root(P, s, flags=P.api.BR_HOLD)
    kids = s.branch(root, P.api.BR_HOLD, 3)
    groups = {s.engine.kv.tree.node(s.seq_of(hd)).group for hd in kids}
    seq_kids = [s.branch(root, P.api.BR_HOLD, 1)[0] for _ in range(2)]
    seq_groups = {s.engine.kv.tree.node(s.seq_of(hd)).group
                  for hd in seq_kids}
    assert len(groups) == 1 and len(seq_groups) == 2
    return sorted(groups), sorted(seq_groups)


@scenario
def vectorized_fork_midvector_error_leaves_no_orphans(P):
    s = session(P)
    root = opened_root(P, s, flags=P.api.BR_HOLD)
    before_handles = set(s.open_handles())
    before_free = s.engine.kv.free_pages
    calls = {"n": 0}
    real_unhold = s.sched.unhold

    def flaky_unhold(seq):
        calls["n"] += 1
        if calls["n"] == 2:
            raise P.api.BranchError("injected mid-vector failure",
                                    errno=P.api.Errno.EBUSY)
        real_unhold(seq)

    s.sched.unhold = flaky_unhold
    try:
        err = refusal(s.branch, root, 0, 3)
    finally:
        s.sched.unhold = real_unhold
    assert calls["n"] == 2
    assert set(s.open_handles()) == before_handles
    assert s.engine.kv.free_pages == before_free
    kids = s.branch(root, P.api.BR_HOLD, 3)
    s.commit(kids[0])
    return err, kids, s.finish(root), s.tree()


# ---------------------------------------------------------------------------
# composite sessions, introspection
# ---------------------------------------------------------------------------

@scenario
def composite_branch_commit_promotes_store_domain(P):
    store = P.core.BranchStore({"plan": b"root"})
    s = session(P, store=store)
    root = opened_root(P, s, flags=P.api.BR_HOLD)
    kids = s.branch(root, P.api.BR_HOLD, 2)
    for i, hd in enumerate(kids):
        s.state_of(hd).write("plan", f"branch-{i}".encode())
    s.commit(kids[1])
    plan = s.state_of(root).read("plan")
    assert plan == b"branch-1"
    s.finish(root)
    assert len(store._tree) == 1
    return plan, counters(s)


@scenario
def introspection_stat_and_tree(P):
    s = session(P)
    root = opened_root(P, s, flags=P.api.BR_HOLD)
    kids = s.branch(root, P.api.BR_HOLD | P.api.BR_SPECULATIVE, 2)
    st = s.stat(kids[0])
    assert st["depth"] == 1 and st["parent"] == root
    assert {"BR_SPECULATIVE", "BR_HOLD"} <= set(st["flags"])
    assert st["status"] == "active" and st["held"]
    view = s.tree()
    assert view["handles"]["open"] == 3
    (root_node,) = view["branches"]
    assert root_node["status"] == "frozen"
    metrics = s.stat(metrics=True)
    return st, view, s.format_tree(), metrics["footprints"]


@scenario
def checkpoint_restore_through_the_session(P):
    s = session(P)
    root = opened_root(P, s, flags=P.api.BR_HOLD)
    kids = s.branch(root, P.api.BR_HOLD, 2)
    freed = s.checkpoint(kids[0])
    st = s.stat(kids[0])
    assert st["tiered"] and "BR_TIERED" in st["flags"]
    s.resume(kids[0])                    # restores, then unparks
    s.resume(kids[1])
    s.wait(kids, produced=3, require_all=True)
    return freed, st, [s.tokens(k) for k in kids], s.tree()


# ---------------------------------------------------------------------------
# session close: the graceful-shutdown wake path
# ---------------------------------------------------------------------------

@scenario
def session_close_wakes_blocked_waiter(P):
    s = session(P)
    root = opened_root(P, s, flags=P.api.BR_HOLD)
    out = {}

    def blocked():
        w = P.api.Waiter(s).add(root, P.api.EV_FINISHED)
        t0 = time.perf_counter()
        out["ready"] = w.wait(timeout_steps=10_000_000)
        out["elapsed"] = time.perf_counter() - t0

    t = threading.Thread(target=blocked)
    t.start()
    time.sleep(0.2)
    s.close()
    t.join(timeout=30)
    assert not t.is_alive() and out["elapsed"] < 30
    assert s.closed
    err = refusal(s.open, [1, 2], 4)
    return out["ready"], err, s.tokens(root)[:3], s.step()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_the_reference(pkgs, name):
    want = SCENARIOS[name](pkgs["jax"])
    got = SCENARIOS[name](pkgs["port"])
    assert got == want


# ---------------------------------------------------------------------------
# a seeded random storm, op for op
# ---------------------------------------------------------------------------

OPS = ("open", "branch", "branch", "branch", "commit", "abort", "step",
       "step", "finish", "truncate", "resume", "pause", "stat", "tokens",
       "close", "verify", "wait")


def storm(P, seed, n_ops=70):
    """Random ops over one session; each op's result, or the class and
    errno of its refusal, goes into the log."""
    a = P.api
    rng = np.random.default_rng(seed)
    s = session(P, num_pages=40)
    hds, log = [], []
    flag_bits = (a.BR_HOLD, a.BR_NESTED, a.BR_SPECULATIVE, a.BR_NONBLOCK,
                 a.BR_ISOLATE)
    for _ in range(n_ops):
        op = OPS[rng.integers(len(OPS))]
        pick = hds[rng.integers(len(hds))] if hds else 0
        try:
            if op == "open":
                prompt = rng.integers(1, 500, rng.integers(1, 9)).tolist()
                flags = a.BR_HOLD if rng.random() < 0.5 else 0
                out = s.open(prompt, int(rng.integers(2, 12)), flags)
                hds.append(out)
            elif op == "branch":
                flags = 0
                for bit in flag_bits:
                    if rng.random() < 0.4:
                        flags |= bit
                out = s.branch(pick, flags, int(rng.integers(1, 4)),
                               max_steps=8)
                hds.extend(out)
            elif op == "commit":
                out = s.commit(pick)
            elif op == "abort":
                out = s.abort(pick)
            elif op == "step":
                out = s.step()
            elif op == "finish":
                out = s.finish(pick)
            elif op == "truncate":
                out = s.truncate(pick, int(rng.integers(0, 3)))
            elif op == "resume":
                out = s.resume(pick)
            elif op == "pause":
                out = s.pause(pick)
            elif op == "stat":
                out = s.stat(pick)
            elif op == "tokens":
                out = s.tokens(pick)
            elif op == "close":
                out = s.close(pick)
            elif op == "verify":
                out = s.verify(pick, [[1, 2], [3, 4]])
            else:
                out = s.wait([pick], produced=2, timeout_steps=4)
            log.append((op, out))
        except (a.BranchError, ValueError) as err:
            errno = getattr(err, "errno", None)
            log.append((op, type(err).__name__, getattr(errno, "name", None)))
    for hd in list(s.open_handles()):
        s.finish(hd)
    # close() never resolves a branch: requests whose handles were closed
    # live on in the scheduler until it is told to retire them
    orphans = sorted(s.sched._requests)
    for rid in orphans:
        s.sched.finish(rid)
    view = s.tree()
    assert view["pool"]["pages_free"] == view["pool"]["pages_total"]
    assert view["pool"]["pages_reserved"] == 0
    assert view["handles"]["open"] == 0
    return log, orphans, view, counters(s)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_storm_op_for_op(pkgs, seed):
    want = storm(pkgs["jax"], seed)
    got = storm(pkgs["port"], seed)
    refused = [e for e in got[0] if len(e) == 3]
    assert refused and len(refused) < len(got[0])   # both kinds occurred
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        assert g == w, f"op {i}: port {g} != reference {w}"
    assert got == want
