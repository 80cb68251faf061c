"""Port parity: the branchable paged-KV ServeEngine against the JAX one.

Both engines run from one set of weights (the JAX package's
``Model.init(PRNGKey(0))`` through numpy and ``params_from_jax``) on
``paper-agentic`` at float32, the port with ``device="cpu"`` (its kernels'
plain versions), the JAX engine with ``attn_impl="fused_ref"`` (the same
fused step with the chunk kernel's jnp oracle).  Greedy runs must give
identical tokens and identical fault/dispatch counters; step logits agree
within 1e-4 (float32 on both sides, different summation orders through
four layers).  Sampled runs use different random streams in the two
packages, so they are held on structure: a drained pool.  The legacy
``attn_impl="ref"`` step (CoW copies as their own dispatch, then the
token's K/V in its slot and cached-only attention) is held against the
JAX engine's ``"ref"`` path and against the port's own fused path.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.runtime.serve_loop as jax_serve
from repro.configs import get_config
from repro.models.model import Model as JaxModel
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as port_config
from repro_torch.models import Model
from repro_torch.runtime import ServeEngine
from repro_torch.runtime import serve_loop as port_serve
from torch_parity import shared_stats

TOL = 1e-4
PROMPT = (5, 17, 3, 42, 7, 11, 2, 9, 30, 4, 8, 1, 22)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(get_config("paper-agentic"), dtype="float32")
    pcfg = dataclasses.replace(port_config("paper-agentic"), dtype="float32")
    jmodel = JaxModel(jcfg, attn_chunk=8, remat=False)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    pparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jmodel, jparams, Model(pcfg), pparams


def engines(setup, *, legacy=False, **kw):
    """The JAX and the port engine on one set of weights: the fused paths,
    or with ``legacy`` both ``attn_impl="ref"`` paths."""
    jmodel, jparams, pmodel, pparams = setup
    kw.setdefault("num_pages", 128)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_pages_per_seq", 16)
    return (jax_serve.ServeEngine(
                jmodel, jparams, attn_impl="ref" if legacy else "fused_ref",
                **kw),
            ServeEngine(pmodel, pparams, device="cpu",
                        attn_impl="ref" if legacy else "auto", **kw))


def exercise(eng, prompt=PROMPT):
    """The JAX package's fast-path workout (tests/test_serve_fast_path.py):
    decode, fork (lazy CoW on the partial tail page), decode the children,
    commit one, keep decoding."""
    out = []
    sid = eng.add_request(list(prompt))
    out += eng.decode([sid])
    kids = eng.fork(sid, 3)
    out += eng.decode(kids)
    out += eng.decode(kids)
    out += eng.decode(kids)
    eng.commit(kids[1])
    out += eng.decode([sid])
    return out, sid


def same_stats(jeng, peng):
    js, ps = jeng.stats(), peng.stats()
    js.pop("attn_impl"), ps.pop("attn_impl")
    assert shared_stats(peng, ps) == shared_stats(jeng, js)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp32", "int8"])
def test_exercise_tokens_and_counters_identical(setup, kv_dtype):
    jeng, peng = engines(setup, kv_dtype=kv_dtype)
    jt, jsid = exercise(jeng)
    pt, psid = exercise(peng)
    assert pt == jt
    assert peng.cow_faults == jeng.cow_faults > 0
    assert peng.cow_inline_steps == jeng.cow_inline_steps > 0
    assert peng.cow_dispatches == jeng.cow_dispatches == 0
    # keep decoding the committed winner: pages (and scales) followed it
    for _ in range(4):
        assert peng.decode([psid]) == jeng.decode([jsid])
    same_stats(jeng, peng)


def test_step_logits_match(setup, monkeypatch):
    captured = {"jax": [], "port": []}
    jax_step = jax_serve.paged_fused_decode_step

    def jax_spy(*args, **kw):
        out = jax_step(*args, **kw)
        captured["jax"].append(np.asarray(out[0][:, 0]))
        return out

    port_step = ServeEngine._fused_decode_step

    def port_spy(self, *args):
        logits = port_step(self, *args)
        captured["port"].append(logits.numpy().copy())
        return logits

    monkeypatch.setattr(jax_serve, "paged_fused_decode_step", jax_spy)
    monkeypatch.setattr(ServeEngine, "_fused_decode_step", port_spy)
    jeng, peng = engines(setup)
    exercise(jeng)
    exercise(peng)
    assert len(captured["port"]) == len(captured["jax"]) == 5
    for p, j in zip(captured["port"], captured["jax"]):
        np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL)


def test_spec_verify_identical_and_one_pass(setup):
    jeng, peng = engines(setup)
    rows = {}
    for name, eng in (("jax", jeng), ("port", peng)):
        sid = eng.add_request([9, 8, 7, 6, 5])
        eng.decode([sid])
        (branch,) = eng.fork(sid, 1)
        greedy = [eng.decode([branch])[0] for _ in range(4)]
        drafts = [greedy, [greedy[0], 0, 1, 2], [0, 1, 2, 3]]
        rows[name] = eng.spec_verify(sid, drafts)
        assert eng.verify_dispatches == 1
        assert rows[name][0] == greedy      # teacher-forcing the greedy path
    assert rows["port"] == rows["jax"]
    with pytest.raises(ValueError):
        peng.spec_verify(0, [[1, 2], [1]])


def test_prefix_cache_suffix_prefill(setup):
    """A page-aligned shared head: the second prompt prefills only its
    suffix (through the chunk kernel), the repeat prefills nothing."""
    jeng, peng = engines(setup, prefix_cache=True)
    head = list(range(3, 3 + 12))                # three full pages
    prompts = [head + [40, 41, 42, 43, 44, 45], head + [50, 51, 52, 53, 54],
               head + [40, 41, 42, 43, 44, 45]]
    tokens = {}
    for name, eng in (("jax", jeng), ("port", peng)):
        sids = [eng.add_request(p) for p in prompts]
        out = eng.decode(sids)
        out += eng.decode(sids)
        tokens[name] = out
    assert tokens["port"] == tokens["jax"]
    assert peng.prefill_dispatches == jeng.prefill_dispatches == 2
    same_stats(jeng, peng)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp32", "int8"])
def test_checkpoint_reuse_restore(setup, kv_dtype):
    # the free list is LIFO, so the next request reuses the freed pages
    jeng, peng = engines(setup, kv_dtype=kv_dtype,
                         tier_host_bytes=1)   # snapshots spill to disk
    tokens = {}
    for name, eng in (("jax", jeng), ("port", peng)):
        sid = eng.add_request(list(PROMPT))
        out = eng.decode([sid])
        freed = eng.checkpoint(sid)
        other = eng.add_request([7] * 30)        # reuses the freed pages
        out += eng.decode([other])
        eng.release(other)
        eng.restore(sid)
        out += [eng.decode([sid])[0] for _ in range(3)]
        tokens[name] = (out, freed)
    assert tokens["port"] == tokens["jax"]
    # the restored branch continues exactly as one never tiered
    _, control = engines(setup, kv_dtype=kv_dtype)
    sid = control.add_request(list(PROMPT))
    expect = control.decode([sid]) + [control.decode([sid])[0]
                                      for _ in range(3)]
    out = tokens["port"][0]
    assert [out[0]] + out[2:] == expect


def test_eager_fork_truncate_abort_release(setup):
    jeng, peng = engines(setup)
    tokens = {}
    for name, eng in (("jax", jeng), ("port", peng)):
        sid = eng.add_request(list(range(1, 14)))
        out = eng.decode([sid])
        kids = eng.fork(sid, 3, eager_cow=True)
        out += eng.decode(kids)
        eng.truncate(kids[0], 14)
        out += eng.decode(kids)
        eng.abort(kids[2])
        eng.commit(kids[0])
        out += eng.decode([sid])
        eng.release(sid)
        tokens[name] = out
        assert eng.stats()["pages_free"] == eng.stats()["pages_total"]
    assert tokens["port"] == tokens["jax"]
    assert peng.cow_dispatches == jeng.cow_dispatches == 1
    same_stats(jeng, peng)


def test_sampled_cycle_drains_the_pool(setup):
    _, peng = engines(setup)
    gen = torch.Generator().manual_seed(3)
    sid = peng.add_request(list(PROMPT))
    kids = peng.fork(sid, 4)
    for _ in range(3):
        out = peng.decode(kids, greedy=[False, True, False, False],
                          temperature=[1.0, 1.0, 0.5, 2.0], generator=gen)
        assert all(0 <= t < peng.cfg.vocab_size for t in out)
    assert all(len(peng.tokens(k)) == len(PROMPT) + 3 for k in kids)
    peng.commit(kids[2])
    assert peng.stats()["sequences_live"] == 1
    peng.release(sid)
    st = peng.stats()
    assert st["pages_free"] == st["pages_total"] and st["token_tails"] == 0
    # the engine's own generator is seeded: sampled runs repeat
    runs = []
    for _ in range(2):
        _, eng = engines(setup)
        s = eng.add_request(list(PROMPT))
        runs.append([eng.decode([s], greedy=False)[0] for _ in range(3)])
    assert runs[0] == runs[1]


def test_no_device_and_no_cuda_raises(setup, monkeypatch):
    _, _, pmodel, pparams = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(pmodel, pparams)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_serve.resolve_device(None)


def test_paths_outside_this_slice_raise(setup):
    """Unknown options raise; tensor-parallel serving (once refused here)
    runs: ``tp=2`` on the CPU is a two-shard engine."""
    _, _, pmodel, pparams = setup
    eng = ServeEngine(pmodel, pparams, device="cpu", tp=2)
    assert eng.tp == eng.stats()["tp"] == len(eng.shards) == 2
    with pytest.raises(ValueError):
        ServeEngine(pmodel, pparams, device="cpu", kv_dtype="int4")
    with pytest.raises(ValueError, match="attn_impl"):
        ServeEngine(pmodel, pparams, device="cpu", attn_impl="pallas")


def test_legacy_ref_path_matches_the_reference_ref_path(setup):
    """Same greedy tokens and CoW counters as the JAX engine's "ref" path:
    faults are serviced as their own dispatches, none ride a step."""
    jeng, peng = engines(setup, legacy=True)
    jt, jsid = exercise(jeng)
    pt, psid = exercise(peng)
    assert pt == jt
    assert peng.cow_faults == jeng.cow_faults > 0
    assert peng.cow_dispatches == jeng.cow_dispatches > 0
    assert peng.cow_inline_steps == jeng.cow_inline_steps == 0
    for _ in range(4):
        assert peng.decode([psid]) == jeng.decode([jsid])
    same_stats(jeng, peng)
    assert peng.stats()["attn_impl"] == "ref"


def test_legacy_ref_path_equals_the_fused_path(setup):
    _, legacy = engines(setup, legacy=True)
    _, fused = engines(setup)
    assert exercise(legacy)[0] == exercise(fused)[0]
    assert legacy.cow_faults == fused.cow_faults
    assert fused.cow_dispatches == 0 and legacy.cow_inline_steps == 0


def test_legacy_ref_step_logits_match(setup, monkeypatch):
    captured = {"jax": [], "port": []}
    jax_step = jax_serve.paged_decode_step

    def jax_spy(*args, **kw):
        out = jax_step(*args, **kw)
        captured["jax"].append(np.asarray(out[0][:, 0]))
        return out

    port_step = ServeEngine._legacy_decode_step

    def port_spy(self, *args):
        logits = port_step(self, *args)
        captured["port"].append(logits.numpy().copy())
        return logits

    monkeypatch.setattr(jax_serve, "paged_decode_step", jax_spy)
    monkeypatch.setattr(ServeEngine, "_legacy_decode_step", port_spy)
    jeng, peng = engines(setup, legacy=True)
    exercise(jeng)
    exercise(peng)
    assert len(captured["port"]) == len(captured["jax"]) == 5
    for p, j in zip(captured["port"], captured["jax"]):
        np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL)


def test_int8_pools_refuse_the_legacy_path(setup):
    jmodel, jparams, pmodel, pparams = setup
    with pytest.raises(ValueError, match="int8"):
        jax_serve.ServeEngine(jmodel, jparams, attn_impl="ref",
                              kv_dtype="int8")
    with pytest.raises(ValueError, match="int8"):
        ServeEngine(pmodel, pparams, device="cpu", attn_impl="ref",
                    kv_dtype="int8")


def test_pad_pow2():
    s, d = port_serve._pad_pow2([], [], torch.device("cpu"))
    assert s.shape == (0,) and d.shape == (0,)
    s, d = port_serve._pad_pow2([3, 4, 5], [7, 8, 9], torch.device("cpu"))
    assert s.tolist() == [3, 4, 5, 5] and d.tolist() == [7, 8, 9, 9]
