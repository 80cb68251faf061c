"""Port parity: the multi-tenant front door (``repro_torch.server``) against
the JAX package's ``repro.server``.

Each scenario of ``tests/test_server.py`` runs once per package through a
namespace of that package's modules, keeps the reference test's own
asserts, and returns a record — status codes, errnos, SSE event names and
data, JSON bodies, ``/metrics`` counters — that must be equal across the
two.  Both engines run ``paper-agentic`` at float32 from one set of weights
(page 4, 16 pages per sequence, ``BranchSession(max_batch=8, seed=11)``),
the port on the CPU, the JAX engine on its fused path
(``attn_impl="fused_ref"``).  ``/v1/generate`` is greedy, so its tokens are
held exactly.  The policies sample, and the two packages draw from
different streams, so an exploration's result is held on structure:
commits, policy stats with scores and verified prefixes by count,
generated lengths.  What depends on thread timing (a request that the
drain may finish or evict) is held to the reference's own set of
outcomes.
"""

import asyncio
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

import repro.api as jax_api
import repro.core.errors as jax_errors
import repro.runtime.serve_loop as jax_serve
import repro.server as jax_server
import repro_torch.api as port_api
import repro_torch.core.errors as port_errors
import repro_torch.runtime.serve_loop as port_serve
import repro_torch.server as port_server
from repro.configs import get_config
from repro.models.model import Model as JaxModel
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as port_config
from repro_torch.models import Model
from repro_torch.server import multiplex as port_multiplex
from torch_parity import shared_metric_lines


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
            api=jax_api, errors=jax_errors, server=jax_server,
            engine=lambda **kw: jax_serve.ServeEngine(
                jmodel, jparams, attn_impl="fused_ref", **geometry(kw))),
        "port": types.SimpleNamespace(
            api=port_api, errors=port_errors, server=port_server,
            engine=lambda **kw: port_serve.ServeEngine(
                pmodel, pparams, device="cpu", **geometry(kw))),
    }


def geometry(kw):
    kw.setdefault("page_size", 4)
    kw.setdefault("max_pages_per_seq", 16)
    return kw


def fresh_front_door(P, *, tenants=(), num_pages=128, **kw):
    engine = P.engine(num_pages=num_pages, **kw)
    session = P.api.BranchSession(engine, max_batch=8, seed=11)
    return P.server.FrontDoor(
        session, [P.server.TenantConfig(name, **cfg) for name, cfg in tenants])


def run_served(P, coro_fn, **fd_kw):
    """Boot a front door, run ``coro_fn(fd)``, always drain cleanly."""

    async def body():
        fd = fresh_front_door(P, **fd_kw)
        await fd.start_backend()
        try:
            return await coro_fn(fd)
        finally:
            if fd.mux.running:
                await fd.shutdown(drain=True, timeout=60)

    return asyncio.run(body())


async def collect(resp):
    assert resp.events is not None, f"expected a stream, got {resp.body}"
    out = []
    async for event, data in resp.events:
        out.append((event, data))
    return out


VALUE_STATS = ("accepted", "acceptance_rate", "fallback")


def result_shape(body):
    """A sampled exploration's terminal body, token values left out."""
    out = {k: v for k, v in body.items()
           if k not in ("tokens", "generated", "result")}
    out["n_tokens"] = len(body.get("tokens", []))
    res = body.get("result")
    if res is not None:
        # scores, verified prefixes and a speculative round's acceptance
        # follow the sampled token values
        stats = {k: (len(v) if k in ("scores", "verified_per_draft")
                     else type(v).__name__ if k in VALUE_STATS else v)
                 for k, v in res["stats"].items() if k != "levels"}
        stats["levels"] = [{k: (len(v) if k == "scores" else v)
                            for k, v in lv.items() if k != "winner_seq"}
                           for lv in res["stats"].get("levels", [])]
        out["result"] = (res["committed"], res["policy"],
                         len(res["tokens"]), len(res["generated"]), stats)
    return out


async def seated(fd, sids, timeout=60.0):
    """Wait until admission has seated every request in ``sids`` (the
    reference sleeps 0.2 s; a first prefill can take longer on a loaded
    machine, and the records must not depend on it)."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        states = [fd.registry.get(sid).state for sid in sids]
        if all(st == "running" for st in states):
            return
        await asyncio.sleep(0.01)
    raise AssertionError(f"not seated in {timeout} s: {states}")


def held_record(resp):
    """A ``"hold": true`` answer: its ``state`` is read while the engine
    thread may already be seating the request, so either is right."""
    body = dict(resp.body)
    if resp.status == 200:
        assert body.pop("state") in ("queued", "running")
    return resp.status, body


#: the reference's histogram the port does not keep: its clock stopped at
#: the prefill's enqueue; the port's traced engine records an
#: ``engine.add_request`` span with the prefill's phases instead
NOT_PORTED = ("hist", "engine.prefill_us")


def metrics_record(P, text, counts=True):
    """Counters whole (they count structure) unless requests raced for the
    engine's steps; gauges and histograms by kind and name (their values
    are times and levels).  The reference has ``NOT_PORTED`` and the port
    has not, the port has its decode-graph metrics (``torch_parity``) and
    the reference has not; the rest is compared."""
    out = []
    for ln in shared_metric_lines(P.server is not jax_server,
                                  text.splitlines()):
        kind, name = ln.split()[:2]
        out.append(ln if kind == "counter" and counts else (kind, name))
    assert (NOT_PORTED in out) == (P.server is jax_server)
    return sorted((x for x in out if x != NOT_PORTED), key=str)


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------------------
# generate: SSE lifecycle + content
# ---------------------------------------------------------------------------

@scenario
def generate_streams_waiter_lifecycle(P):
    async def body(fd):
        resp = await fd.dispatch("POST", "/v1/generate", {
            "prompt": [1, 2, 3], "max_new_tokens": 6})
        assert resp.status == 200
        events = await collect(resp)
        names = [e for e, _ in events]
        assert names[0] == "admitted"
        assert "EV_ADMITTED" in events[0][1]["events"]
        assert names[-1] == "finished"
        assert "EV_FINISHED" in events[-1][1]["events"]
        streamed = [t for e, d in events if e == "token"
                    for t in d["tokens"]]
        final = events[-1][1]
        assert len(streamed) == 6
        assert final["tokens"][:3] == [1, 2, 3]
        assert final["generated"] == streamed
        return events

    first = run_served(P, body)
    # greedy chat is deterministic: a fresh engine re-serves identically
    second = run_served(P, body)
    assert first[-1][1]["generated"] == second[-1][1]["generated"]
    return first, second


@scenario
def generate_nonstream_and_bad_requests(P):
    async def body(fd):
        resp = await fd.dispatch("POST", "/v1/generate", {
            "prompt": [4, 5], "max_new_tokens": 4, "stream": False})
        assert resp.status == 200
        assert resp.body["event"] == "finished"
        assert len(resp.body["generated"]) == 4

        bad = await fd.dispatch("POST", "/v1/generate", {"prompt": []})
        assert bad.status == 400
        missing = await fd.dispatch("GET", "/v1/nope")
        assert missing.status == 404
        verb = await fd.dispatch("PUT", "/v1/generate")
        return [(r.status, r.body) for r in (resp, bad, missing, verb)]

    return run_served(P, body)


# ---------------------------------------------------------------------------
# explore: policies through the shared driver
# ---------------------------------------------------------------------------

@scenario
def explore_best_of_n_commits_and_drains(P):
    async def body(fd):
        before = fd.session.tree()["pool"]["pages_reserved"]
        resp = await fd.dispatch("POST", "/v1/explore", {
            "prompt": [7, 8, 9], "policy": "best_of_n",
            "max_new_tokens": 12, "params": {"n": 3, "tokens": 6},
            "stream": False})
        assert resp.status == 200, resp.body
        res = resp.body["result"]
        assert res["committed"] is True
        assert res["stats"]["policy"] == "best_of_n" or res["stats"]
        assert resp.body["tokens"][:3] == [7, 8, 9]
        # N explorations entering means a drained pool leaving
        after = fd.session.tree()["pool"]["pages_reserved"]
        assert after == before

        unknown = await fd.dispatch("POST", "/v1/explore", {
            "prompt": [1], "policy": "dfs"})
        assert unknown.status == 400
        badparam = await fd.dispatch("POST", "/v1/explore", {
            "prompt": [1], "policy": "best_of_n",
            "params": {"score_fn": "x"}})
        assert badparam.status == 400
        return (resp.status, result_shape(resp.body), before, after,
                [(r.status, r.body) for r in (unknown, badparam)])

    return run_served(P, body)


@scenario
def mixed_concurrent_load_one_engine(P):
    async def body(fd):
        chats = [fd.dispatch("POST", "/v1/generate", {
            "tenant": "a", "prompt": [i + 1], "max_new_tokens": 5,
            "stream": False}) for i in range(3)]
        explores = [fd.dispatch("POST", "/v1/explore", {
            "tenant": "b", "prompt": [10 + i, 2], "policy": policy,
            "max_new_tokens": 10, "params": params, "stream": False})
            for i, (policy, params) in enumerate([
                ("best_of_n", {"n": 2, "tokens": 4}),
                ("speculative", {"n_drafts": 2, "draft_tokens": 3}),
                ("beam", {"width": 2, "depth": 2,
                          "tokens_per_level": 3}),
            ])]
        results = await asyncio.gather(*chats, *explores)
        assert [r.status for r in results] == [200] * 6
        for r in results[:3]:
            assert r.body["event"] == "finished"
            assert len(r.body["generated"]) == 5
        for r in results[3:]:
            assert r.body["event"] == "result", r.body
        # everything retired: no live records, pool drained
        assert len(fd.registry.live) == 0
        assert fd.session.tree()["pool"]["pages_reserved"] == 0
        # launch order (the sids) follows the engine thread: key by prompt
        chat = sorted((r.body["tokens"], r.body["generated"], r.body["event"])
                      for r in results[:3])
        spec = sorted((r.body["tokens"][:2], r.body["result"]["policy"],
                       str(result_shape({k: v for k, v in r.body.items()
                                         if k != "id"})))
                      for r in results[3:])
        return chat, spec

    return run_served(P, body, tenants=[
        ("a", dict(max_concurrent=8, priority=2)),
        ("b", dict(max_concurrent=8, priority=1))])


# ---------------------------------------------------------------------------
# tenancy: quotas reject without ledger movement
# ---------------------------------------------------------------------------

@scenario
def quota_429_leaves_ledger_untouched(P):
    async def body(fd):
        held = await fd.dispatch("POST", "/v1/generate", {
            "tenant": "tiny", "prompt": [1, 2], "max_new_tokens": 8,
            "hold": True})
        assert held.status == 200

        def snap(s):
            c = s.obs.metrics.snapshot()["counters"]
            return (c.get("sched.submitted", 0), c.get("sched.rejected", 0),
                    s.sched.stats()["pages_reserved"])

        before = await fd.mux.call(snap)
        resp = await fd.dispatch("POST", "/v1/generate", {
            "tenant": "tiny", "prompt": [3, 4], "max_new_tokens": 8})
        assert resp.status == 429
        assert resp.body["errno"] == "EAGAIN"
        after = await fd.mux.call(snap)
        # the 429 never reached the scheduler: no submit, no reject,
        # no reservation movement
        assert after == before

        c = fd.session.obs.metrics.snapshot()["counters"]
        assert c["server.quota_429"] >= 1
        return (held_record(held), resp.status, resp.body, before,
                after, c["server.quota_429"])

    return run_served(P, body, tenants=[
        ("tiny", dict(max_concurrent=1, priority=1))])


@scenario
def never_fits_is_507_enospc(P):
    async def body(fd):
        sub_before = await fd.mux.call(
            lambda s: s.obs.metrics.snapshot()["counters"].get(
                "sched.submitted", 0))
        resp = await fd.dispatch("POST", "/v1/generate", {
            "prompt": [1] * 10, "max_new_tokens": 500, "stream": False})
        assert resp.status == 507
        assert resp.body["errno"] == "ENOSPC"
        sub_after = await fd.mux.call(
            lambda s: s.obs.metrics.snapshot()["counters"].get(
                "sched.submitted", 0))
        assert sub_after == sub_before
        return resp.status, resp.body, sub_before, sub_after

    return run_served(P, body)


@scenario
def page_quota_caps_reservations(P):
    async def body(fd):
        first = await fd.dispatch("POST", "/v1/generate", {
            "tenant": "capped", "prompt": [1, 2], "max_new_tokens": 8,
            "hold": True})
        assert first.status == 200          # 3 pages of the 4-page cap
        second = await fd.dispatch("POST", "/v1/generate", {
            "tenant": "capped", "prompt": [3, 4], "max_new_tokens": 8,
            "hold": True})
        assert second.status == 429
        return [held_record(r) for r in (first, second)]

    return run_served(P, body, tenants=[
        ("capped", dict(max_concurrent=8, max_reserved_pages=4,
                        priority=1))])


# ---------------------------------------------------------------------------
# preemption: held/speculative victims only, committed chains intact
# ---------------------------------------------------------------------------

@scenario
def preemption_evicts_held_only_and_keeps_chains(P):
    async def body(fd):
        # low-priority tenant: one finished chat (its committed chain)
        # and three parked holds filling the 24-page pool
        done = await fd.dispatch("POST", "/v1/generate", {
            "tenant": "batch", "prompt": [5, 6], "max_new_tokens": 4,
            "stream": False})
        assert done.status == 200
        committed = done.body["tokens"]

        holds = []
        for _ in range(3):
            r = await fd.dispatch("POST", "/v1/generate", {
                "tenant": "batch", "prompt": [1, 2, 3, 4],
                "max_new_tokens": 24, "hold": True})   # 7 pages each
            assert r.status == 200
            holds.append(r.body["id"])
        await seated(fd, holds)    # let admission seat the holds

        # high-priority chat cannot fit without preempting a hold
        vip = await fd.dispatch("POST", "/v1/generate", {
            "tenant": "vip", "prompt": [9, 9, 9, 9],
            "max_new_tokens": 24, "stream": False})
        assert vip.status == 200, vip.body
        assert vip.body["event"] == "finished"
        assert len(vip.body["generated"]) == 24

        states = {}
        for sid in holds:
            t = await fd.dispatch("GET", f"/v1/sessions/{sid}/tree")
            states[sid] = t.body
        # demote-before-deny: parked victims are checkpointed to the
        # tier store, not killed — every hold is still live, and the
        # demoted one keeps its handle, tokens and reservation
        demoted = [b for b in states.values() if b["demoted"]]
        assert all(b["state"] == "running" for b in states.values())
        assert len(demoted) >= 1            # pressure was relieved...
        for b in demoted:                   # ...by tiering parked holds
            assert b["kind"] == "parked"
            assert b["stat"]["tiered"] is True
            assert "BR_TIERED" in b["stat"]["flags"]

        c = fd.session.obs.metrics.snapshot()["counters"]
        assert c["server.demotions"] == len(demoted)
        assert c.get("server.preemptions", 0) == 0   # nothing evicted
        # the victim tenant's finished request is untouched history
        assert committed[:2] == [5, 6]
        return (committed, vip.body, holds,
                [(b["id"], b["state"], b["demoted"]) for b in
                 states.values()],
                c["server.demotions"], c.get("server.preemptions", 0))

    return run_served(P, body, num_pages=24, tenants=[
        ("vip", dict(max_concurrent=8, priority=3)),
        ("batch", dict(max_concurrent=8, priority=1))])


@scenario
def equal_priority_never_preempts(P):
    async def body(fd):
        holds = []
        for _ in range(3):
            r = await fd.dispatch("POST", "/v1/generate", {
                "tenant": "a", "prompt": [1, 2, 3, 4],
                "max_new_tokens": 24, "hold": True})
            assert r.status == 200
            holds.append(r.body["id"])
        await seated(fd, holds)
        # same priority: nothing may be EVICTED — priority governs only
        # lossy preemption.  Demotion is lossless, so the scheduler
        # checkpoints a hold to the tier store and seats the chat
        # instead of blocking the FIFO forever.
        resp = await fd.dispatch("POST", "/v1/generate", {
            "tenant": "b", "prompt": [9, 9, 9, 9],
            "max_new_tokens": 24, "stream": False})
        assert resp.status == 200, resp.body
        assert len(resp.body["generated"]) == 24
        c = fd.session.obs.metrics.snapshot()["counters"]
        assert c["server.preemptions"] == 0
        assert c["sched.demotions"] >= 1
        # every hold survived; the demoted one kept handle + tokens
        states = []
        for sid in holds:
            t = await fd.dispatch("GET", f"/v1/sessions/{sid}/tree")
            assert t.body["state"] == "running"
            states.append((t.body["state"], t.body["demoted"]))
        # drain evicts the holds cleanly — including the tiered one
        stats = await fd.shutdown(drain=True, timeout=60)
        assert stats["evicted"] >= 3
        return (resp.body, c["server.preemptions"], c["sched.demotions"],
                states, stats)

    return run_served(P, body, num_pages=24, tenants=[
        ("a", dict(max_concurrent=8, priority=1)),
        ("b", dict(max_concurrent=8, priority=1))])


# ---------------------------------------------------------------------------
# tenancy manager unit surface
# ---------------------------------------------------------------------------

@scenario
def tenancy_worst_pages_mirrors_scheduler(P):
    engine = P.engine(num_pages=64)
    session = P.api.BranchSession(engine, max_batch=8, seed=11)
    tm = P.server.TenancyManager(session)
    hd = session.open([1, 2, 3], max_new_tokens=9)
    req = session.sched.request_of(session.req_id_of(hd))
    assert tm.worst_pages(3, 9) == req.worst_pages
    session.finish(hd)

    with pytest.raises(P.errors.AdmissionDenied) as exc:
        tm.check_admit("anyone", 10, 10_000)
    assert exc.value.errno is P.errors.Errno.ENOSPC
    return tm.worst_pages(3, 9), str(exc.value), exc.value.errno.name


@scenario
def tenancy_victim_ordering(P):
    engine = P.engine(num_pages=64)
    session = P.api.BranchSession(engine, max_batch=8, seed=11)
    tm = P.server.TenancyManager(session, [
        P.server.TenantConfig("lo", priority=1),
        P.server.TenantConfig("mid", priority=2)])

    mk = lambda sid, tenant, kind, pre: P.server.ServedRequest(  # noqa: E731
        sid=sid, tenant=tenant, kind=kind, prompt_len=1,
        max_new_tokens=1, worst_pages=1, preemptible=pre)
    spec_lo = mk(0, "lo", "explore", True)
    park_lo = mk(1, "lo", "parked", True)
    chat_lo = mk(2, "lo", "chat", False)       # never a victim
    park_mid = mk(3, "mid", "parked", True)
    for r in (spec_lo, park_lo, chat_lo, park_mid):
        tm.attach(r)

    victims = tm.victims_for(priority=3)
    # parked before speculative, low priority before mid, no chat ever
    assert [v.sid for v in victims] == [1, 0, 3]
    assert tm.victims_for(priority=2) == [park_lo, spec_lo]
    assert tm.victims_for(priority=1) == []

    with pytest.raises(P.server.QuotaExceeded) as exc:
        for i in range(99):
            tm.check_admit("lo", 1, 1)
            tm.attach(mk(100 + i, "lo", "chat", False))
    return ([v.sid for v in victims],
            [v.sid for v in tm.victims_for(priority=2)],
            str(exc.value), exc.value.errno.name, tm.usage())


# ---------------------------------------------------------------------------
# introspection + shutdown
# ---------------------------------------------------------------------------

@scenario
def tree_metrics_and_tenants_endpoints(P):
    async def body(fd):
        held = await fd.dispatch("POST", "/v1/generate", {
            "tenant": "t", "prompt": [1, 2], "max_new_tokens": 8,
            "hold": True})
        sid = held.body["id"]
        await seated(fd, [sid])

        tree = await fd.dispatch("GET", f"/v1/sessions/{sid}/tree")
        assert tree.status == 200
        assert tree.body["kind"] == "parked"
        assert tree.body["state"] == "running"
        assert tree.body["preemptible"] is True
        assert "pool" in tree.body["session"]
        assert tree.body["stat"]["held"] is True

        missing = await fd.dispatch("GET", "/v1/sessions/999/tree")
        assert missing.status == 404
        badsid = await fd.dispatch("GET", "/v1/sessions/x/tree")

        metrics = await fd.dispatch("GET", "/metrics")
        assert metrics.status == 200
        assert "server.requests" in metrics.text
        assert "sched.admitted" in metrics.text

        tenants = await fd.dispatch("GET", "/v1/tenants")
        assert tenants.body["tenants"]["t"]["live"] == 1
        assert tenants.body["tenants"]["t"]["reserved_pages"] > 0
        health = await fd.dispatch("GET", "/healthz")
        return (held_record(held), tree.body, (missing.status, missing.body),
                (badsid.status, badsid.body), metrics_record(P, metrics.text),
                tenants.body, (health.status, health.body))

    return run_served(P, body, tenants=[
        ("t", dict(max_concurrent=4, priority=2))])


@scenario
def graceful_shutdown_drains_and_refuses(P):
    async def body(fd):
        held = await fd.dispatch("POST", "/v1/generate", {
            "prompt": [1, 2], "max_new_tokens": 8, "hold": True})
        assert held.status == 200
        inflight = asyncio.ensure_future(fd.dispatch(
            "POST", "/v1/generate", {
                "prompt": [3, 4], "max_new_tokens": 6, "stream": False}))
        await asyncio.sleep(0.05)

        stats = await fd.shutdown(drain=True, timeout=60)
        assert stats["evicted"] >= 1        # the parked hold
        # the in-flight decode was NOT cut off: it finished (or was
        # launched late enough to be evicted by the drain — never lost)
        resp = await inflight
        assert resp.status in (200, 409, 503)
        if resp.status == 200:
            assert len(resp.body["generated"]) == 6

        after = await fd.dispatch("POST", "/v1/generate", {
            "prompt": [9], "max_new_tokens": 2})
        assert after.status == 503
        assert fd.session.closed
        assert len(fd.registry.live) == 0
        health = await fd.dispatch("GET", "/healthz")
        return (held_record(held), stats["evicted"] >= 1,
                (after.status, after.body),
                fd.session.closed, (health.status, health.body))

    return run_served(P, body)


@scenario
def client_disconnect_evicts_stream(P):
    async def body(fd):
        resp = await fd.dispatch("POST", "/v1/generate", {
            "prompt": [1, 2], "max_new_tokens": 60})
        agen = resp.events
        first = await agen.__anext__()
        assert first[0] == "admitted"
        sid = first[1]["id"]
        await agen.aclose()                 # client went away mid-stream
        for _ in range(100):
            rec = fd.registry.get(sid)
            if rec is not None and not rec.live:
                break
            await asyncio.sleep(0.02)
        rec = fd.registry.get(sid)
        assert rec is not None and rec.state == "evicted"
        assert "client disconnected" in rec.evict_reason
        # its reservations went back to the pool
        assert fd.session.tree()["pool"]["pages_reserved"] == 0
        return first, rec.state, rec.evict_reason, \
            fd.session.tree()["pool"]

    return run_served(P, body)


# ---------------------------------------------------------------------------
# the real socket path
# ---------------------------------------------------------------------------

@scenario
def socket_roundtrip_with_serve_client(P):
    async def body():
        fd = fresh_front_door(P, tenants=[
            ("s", dict(max_concurrent=8, priority=1))])
        server = await fd.serve("127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        client = P.server.ServeClient(f"http://127.0.0.1:{port}")
        try:
            health = await client.health()
            assert health["ok"] is True

            fin, res = await asyncio.gather(
                client.generate([1, 2, 3], tenant="s", max_new_tokens=5),
                client.explore([4, 5], policy="best_of_n", tenant="s",
                               max_new_tokens=8,
                               params={"n": 2, "tokens": 4}))
            assert fin["event"] == "finished"
            assert len(fin["generated"]) == 5
            assert res["event"] == "result"

            metrics = await client.metrics()
            assert "server.tokens_streamed" in metrics
            with pytest.raises(P.server.ServeError) as exc:
                await client.tree(999)
            return (health, {k: v for k, v in fin.items() if k != "id"},
                    result_shape({k: v for k, v in res.items()
                                  if k != "id"}),
                    metrics_record(P, metrics, counts=False), exc.value.status,
                    exc.value.body)
        finally:
            await fd.shutdown(drain=True, timeout=60)

    return asyncio.run(body())


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_the_reference(pkgs, name):
    want = SCENARIOS[name](pkgs["jax"])
    got = SCENARIOS[name](pkgs["port"])
    assert got == want


# ---------------------------------------------------------------------------
# the port's own: JSON of tensors, and a crash of the engine thread
# ---------------------------------------------------------------------------

def test_jsonable_reads_tensors_as_the_reference_reads_arrays():
    from repro.server.multiplex import jsonable as jax_jsonable

    cases = [(torch.tensor(3), jax.numpy.int32(3)),
             (torch.tensor(2.5), jax.numpy.float32(2.5)),
             (torch.tensor([1, 2, 3]), jax.numpy.array([1, 2, 3])),
             (torch.tensor([0.5, 1.5]), jax.numpy.array([0.5, 1.5])),
             (torch.tensor([1.0], dtype=torch.bfloat16),
              jax.numpy.array([1.0])),
             ({"s": [torch.tensor(True)]}, {"s": [jax.numpy.bool_(True)]})]
    for t, j in cases:
        assert port_multiplex.jsonable(t) == jax_jsonable(j)


def test_engine_crash_reaches_every_stream(pkgs):
    """An exception on the engine thread ends every open stream with an
    ``error`` event, fails queued commands, and turns new work away (503)
    with ``/healthz`` at 500 — no awaiter is left hanging."""
    P = pkgs["port"]

    async def body():
        fd = fresh_front_door(P)
        await fd.start_backend()
        driver_step = fd.driver.step
        calls = [0]

        def failing_step(**kw):
            calls[0] += 1
            if calls[0] == 3:
                raise RuntimeError("injected engine fault")
            return driver_step(**kw)

        streams = [await fd.dispatch("POST", "/v1/generate", {
            "prompt": [1, 2, i + 3], "max_new_tokens": 30})
            for i in range(2)]
        # armed once both streams are open: a fault armed before the
        # second dispatch could end the loop before that stream existed
        fd.driver.step = failing_step
        events = await asyncio.wait_for(
            asyncio.gather(*(collect(s) for s in streams)), 30)
        for ev in events:
            assert ev[-1][0] == "error"
            assert "injected engine fault" in ev[-1][1]["message"]
        after = await fd.dispatch("POST", "/v1/generate", {
            "prompt": [9], "max_new_tokens": 2})
        health = await fd.dispatch("GET", "/healthz")
        with pytest.raises(P.errors.BranchStateError):
            await fd.mux.call(lambda s: None)
        await fd.shutdown(drain=True, timeout=10)
        return after.status, health.status, len(fd.registry.live)

    assert asyncio.run(body()) == (503, 500, 0)
