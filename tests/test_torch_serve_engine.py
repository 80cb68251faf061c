"""Port parity: the serving engine's branch lifecycle, its fast-path
verify and int8 eager fork, and the scheduler's demote-before-deny,
against the JAX package.

Each scenario of ``tests/test_serve_engine.py`` (7), of
``tests/test_serve_fast_path.py`` that passes in the reference
(``test_int8_scales_copied_on_eager_fork``,
``test_spec_verify_matches_sequential_verifier``) and of
``tests/test_kv_tier.py`` (``test_scheduler_demotes_held_before_denying``,
``test_resume_transparently_restores_demoted_branch``) runs once per
package through a namespace of that package's modules, keeps the
reference test's own asserts, and returns a record — tokens, engine
counters, page counts, scheduler stats and the class and errno of every
refusal — that must be equal across the two.  Both engines run
``paper-agentic`` at float32 from one set of weights, the port on the CPU.
The JAX engine's ``attn_impl`` names map onto the port's: ``"ref"`` on
``"ref"`` (the legacy two-dispatch path), ``"fused_ref"`` and
``"interpret"`` on ``"auto"`` (the fused path, on the CPU through the
kernels' plain versions).  The dense-cache oracle of
``test_paged_decode_matches_dense_reference`` is the JAX model's own
decode path, held against both engines.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jax_api
import repro.runtime.scheduler as jax_sched
import repro.runtime.serve_loop as jax_serve
import repro_torch.api as port_api
import repro_torch.runtime.scheduler as port_sched
import repro_torch.runtime.serve_loop as port_serve
from repro.configs import get_config
from repro.models.model import Model as JaxModel
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as port_config
from repro_torch.models import Model

PORT_IMPL = {"ref": "ref", "fused_ref": "auto", "interpret": "auto"}


@pytest.fixture(scope="module")
def pkgs():
    jcfg = dataclasses.replace(get_config("paper-agentic"), dtype="float32")
    pcfg = dataclasses.replace(port_config("paper-agentic"), dtype="float32")
    jmodel = JaxModel(jcfg, attn_chunk=8, remat=False)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    pparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    pmodel = Model(pcfg)

    def jax_engine(attn_impl="fused_ref", **kw):
        return jax_serve.ServeEngine(jmodel, jparams, attn_impl=attn_impl,
                                     **geometry(kw))

    def port_engine(attn_impl="fused_ref", **kw):
        return port_serve.ServeEngine(pmodel, pparams, device="cpu",
                                      attn_impl=PORT_IMPL[attn_impl],
                                      **geometry(kw))

    def jax_sample(eng, seqs, step):
        return eng.decode(seqs, greedy=False, temperature=5.0,
                          key=jax.random.fold_in(jax.random.PRNGKey(0),
                                                 step))

    def port_sample(eng, seqs, step):
        return eng.decode(seqs, greedy=False, temperature=5.0,
                          generator=torch.Generator().manual_seed(step))

    return {
        "jax": types.SimpleNamespace(api=jax_api, sched=jax_sched,
                                     engine=jax_engine, sample=jax_sample),
        "port": types.SimpleNamespace(api=port_api, sched=port_sched,
                                      engine=port_engine, sample=port_sample),
        "oracle": (jmodel, jparams),
    }


def geometry(kw):
    kw.setdefault("num_pages", 128)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_pages_per_seq", 16)
    return kw


def refusal(fn, *args, **kw):
    with pytest.raises(Exception) as exc:
        fn(*args, **kw)
    errno = getattr(exc.value, "errno", None)
    return type(exc.value).__name__, getattr(errno, "name", errno)


def dense_reference_generate(model, params, prompt, n_new):
    """Oracle: dense-cache decode via the JAX model's own decode path."""
    toks = list(prompt)
    cache = model.init_decode_state(1, 64)
    logits, pref = model.prefill(params, jnp.asarray(toks[:-1],
                                                     jnp.int32)[None],
                                 max_len=64)
    for k in pref:
        cache[k] = pref[k]
    out = []
    for _ in range(n_new):
        pos = jnp.asarray([len(toks) - 1], jnp.int32)
        logits, cache = model.decode_step(
            params, cache, jnp.asarray([[toks[-1]]], jnp.int32), pos)
        nxt = int(jnp.argmax(logits[0, 0]))
        toks.append(nxt)
        out.append(nxt)
    return out


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------------------
# tests/test_serve_engine.py
# ---------------------------------------------------------------------------

@scenario
def paged_decode_matches_dense_reference(P, oracle):
    eng = P.engine()
    prompt = [5, 17, 3, 42, 7]
    sid = eng.add_request(prompt)
    got = [eng.decode([sid])[0] for _ in range(6)]
    want = dense_reference_generate(*oracle, prompt, 6)
    assert got == want
    return got


@scenario
def batched_decode_multiple_sequences(P, oracle):
    eng = P.engine()
    s1 = eng.add_request([1, 2, 3])
    s2 = eng.add_request([9, 8, 7, 6])
    for _ in range(4):
        eng.decode([s1, s2])
    assert len(eng.tokens(s1)) == 7
    assert len(eng.tokens(s2)) == 8
    return eng.tokens(s1), eng.tokens(s2)


@scenario
def fork_explore_commit_generations(P, oracle):
    """The paper's Listing-2 pattern over generations."""
    eng = P.engine()
    root = eng.add_request([5, 17, 3, 42, 7])
    eng.decode([root])
    b1, b2, b3 = eng.fork(root, 3)
    pages_before = eng.stats()["pages_free"]
    for _ in range(3):
        eng.decode([b1, b2, b3])
    t1, t2, t3 = eng.tokens(b1), eng.tokens(b2), eng.tokens(b3)
    assert t1 == t2 == t3  # greedy decode: identical until sampled apart
    eng.commit(b2)
    assert eng.tokens(root) == t2
    err = refusal(eng.decode, [b1])
    assert err[0] == "StaleBranchError"
    assert eng.stats()["pages_free"] >= pages_before
    eng.decode([root])
    assert len(eng.tokens(root)) == len(t2) + 1
    return t2, err, eng.tokens(root), pages_before, eng.stats()["pages_free"]


@scenario
def forked_branches_diverge_with_sampling(P, oracle):
    eng = P.engine()
    root = eng.add_request([2, 4, 6, 8])
    b1, b2 = eng.fork(root, 2)
    for i in range(4):
        P.sample(eng, [b1, b2], i)
    # CoW isolation: different continuations, shared prefix intact
    assert eng.tokens(b1)[:4] == eng.tokens(b2)[:4] == [2, 4, 6, 8]
    # the two packages sample from different streams: lengths only
    return eng.tokens(b1)[:4], len(eng.tokens(b1)), len(eng.tokens(b2))


@scenario
def branch_isolation_after_cow(P, oracle):
    prompt = [11, 22, 33]
    ctrl = P.engine()
    c = ctrl.add_request(prompt)
    ctrl_tokens = [ctrl.decode([c])[0] for _ in range(4)]

    eng = P.engine()
    root = eng.add_request(prompt)
    b1, b2 = eng.fork(root, 2)
    for _ in range(4):
        eng.decode([b1])
    got = [eng.decode([b2])[0] for _ in range(4)]
    assert got == ctrl_tokens
    assert eng.tokens(b1)[3:] == ctrl_tokens  # greedy: same continuation
    return ctrl_tokens, got, eng.cow_faults


@scenario
def nested_branching(P, oracle):
    eng = P.engine()
    root = eng.add_request([1, 2, 3, 4])
    (child,) = eng.fork(root, 1)
    eng.decode([child])
    g1, g2 = eng.fork(child, 2)
    eng.decode([g1])
    eng.decode([g2])
    eng.commit(g1)               # into child only
    assert len(eng.tokens(child)) == 6
    assert len(eng.tokens(root)) == 4
    eng.commit(child)
    assert len(eng.tokens(root)) == 6
    return eng.tokens(root), eng.stats()["pages_free"]


@scenario
def page_accounting_no_leaks(P, oracle):
    eng = P.engine()
    free0 = eng.stats()["pages_free"]
    root = eng.add_request([1, 2, 3, 4, 5])
    branches = eng.fork(root, 3)
    for _ in range(5):
        eng.decode(branches)
    mid = eng.stats()["pages_free"]
    eng.commit(branches[0])
    eng.kv.release(root)
    assert eng.stats()["pages_free"] == free0
    return free0, mid, eng.stats()["pages_free"]


# ---------------------------------------------------------------------------
# tests/test_serve_fast_path.py (the tests that pass in the reference)
# ---------------------------------------------------------------------------

@scenario
def int8_scales_copied_on_eager_fork(P, oracle):
    """Eager fork CoW must move scales with pages (one fused dispatch)."""
    eng = P.engine(kv_dtype="int8")
    sid = eng.add_request(list(range(1, 14)))
    eng.decode([sid])        # length 13: the tail page is now partial
    before = eng.cow_dispatches
    kids = eng.fork(sid, 2, eager_cow=True)
    assert eng.cow_dispatches == before + 1
    t0 = eng.decode([kids[0]])
    t1 = eng.decode([kids[1]])
    assert t0 == t1                  # same context -> same greedy token
    return before, eng.cow_dispatches, t0, t1


@scenario
def spec_verify_matches_sequential_verifier(P, oracle):
    """One fused verify dispatch == a greedy verifier branch's k steps."""
    out = []
    for impl in ("ref", "fused_ref", "interpret"):
        eng = P.engine(attn_impl=impl)
        sid = eng.add_request([9, 8, 7, 6, 5])
        eng.decode([sid])
        (branch,) = eng.fork(sid, 1)
        seq_tokens = [eng.decode([branch])[0] for _ in range(4)]
        drafts = [seq_tokens,
                  [seq_tokens[0], 0, 1, 2],
                  [0, 1, 2, 3]]
        rows = eng.spec_verify(sid, drafts)
        assert eng.verify_dispatches == 1
        assert rows[0] == seq_tokens
        assert all(r[0] == seq_tokens[0] for r in rows)
        assert rows[1][:2] == seq_tokens[:2]
        out.append((impl, seq_tokens, rows))
    return out


# ---------------------------------------------------------------------------
# tests/test_kv_tier.py: demote-before-deny through the scheduler
# ---------------------------------------------------------------------------

@scenario
def scheduler_demotes_held_before_denying(P, oracle):
    eng = P.engine(num_pages=24)
    sched = P.sched.Scheduler(eng, P.sched.SchedulerConfig(max_batch=8))
    held = []
    for i in range(3):
        rid = sched.submit([i + 1, i + 2, i + 3, i + 4], max_new_tokens=24)
        sched.admit()
        seq = sched.seq_of(rid)
        sched.hold(seq)
        held.append(seq)

    rid = sched.submit([9, 9, 9, 9], max_new_tokens=24)
    admitted = sched.admit()
    assert admitted == [sched.seq_of(rid)]
    assert sched.stats()["checkpointed"] == 1
    tiered = [s for s in held if sched.is_checkpointed(s)]
    assert len(tiered) == 1

    unhold = refusal(sched.unhold, tiered[0])
    assert unhold == ("BranchError", "EAGAIN")
    restore = refusal(sched.restore, tiered[0])
    assert restore[0] == "AdmissionDenied"

    steps = []
    for _ in range(30):
        st = sched.step()
        steps.append(st["running"])
        if st["running"] <= 3:
            break
    sched.restore(tiered[0], unhold=True)
    assert not sched.is_checkpointed(tiered[0])
    assert sched.stats()["checkpointed"] == 0
    before = len(eng.tokens(tiered[0]))
    sched.step()
    assert len(eng.tokens(tiered[0])) == before + 1
    stats = sched.stats()
    stats.pop("attn_impl", None)
    return (held, admitted, tiered, unhold, restore, steps,
            eng.tokens(tiered[0]), stats)


@scenario
def resume_transparently_restores_demoted_branch(P, oracle):
    engine = P.engine()
    s = P.api.BranchSession(engine, max_batch=8, seed=11)
    hd = s.open([1, 2, 3], 12)
    for _ in range(3):
        s.step()
    freed = s.checkpoint(hd)
    assert s.stat(hd)["tiered"] is True
    toks = s.tokens(hd)

    s.resume(hd, greedy=True)            # restore + unhold in one verb
    assert s.stat(hd)["tiered"] is False
    assert s.tokens(hd) == toks          # token-identical round trip
    s.step()
    assert len(s.tokens(hd)) == len(toks) + 1
    view = s.stat(hd)
    final = s.finish(hd)
    return freed, toks, view, final, s.tree()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_the_reference(pkgs, name):
    want = SCENARIOS[name](pkgs["jax"], pkgs["oracle"])
    got = SCENARIOS[name](pkgs["port"], pkgs["oracle"])
    assert got == want
