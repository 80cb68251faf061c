"""Port parity: the hybrid family (``zamba2-7b``) through ``Model`` and
``BranchStore``.

A Mamba2 backbone with ONE weight-shared attention + MLP block applied
after every ``attn_every`` layers on ``concat([h, h0])``.  Two depths at
``reduced()`` widths in float32: ``reduced(zamba2-7b)`` (4 layers,
``attn_every=2``: two applications, no tail) and a 5-layer variant that
ends in one Mamba2 layer after the last application (zamba2-7b itself has
81 = 13 × 6 + 3).  Both packages run from one set of weights: the
reference's ``Model.init(PRNGKey(0))`` through numpy into
``params_from_jax``.  Prefill logits and every cache leaf, then four
``decode_step``s in both position forms (the reference's
``tests/test_aligned_decode.py`` case), must agree within 1e-4: float32 on
both sides, with summation orders that differ between XLA and PyTorch.
The branching cycle of ``tests/test_torch_ssm_branching.py`` runs in both
packages over the hybrid cache: tokens and statuses identical, the
committed ROOT state within 1e-4.  The hybrid ``decode_step`` writes the
shared block's K/V into the cache it is given, so stepping a restored
cache as restored must make the store refuse the next read.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime.serve_loop as jax_serve
from repro.configs import get_config
from repro.configs.base import reduced
from repro.core.errors import StaleBranchError as JaxStale
from repro.core.store import BranchStore as JaxStore
from repro.models.model import Model as JaxModel
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import reduced as port_reduced
from repro_torch.core import BranchStateError, BranchStore, StaleBranchError
from repro_torch.models import Model
from repro_torch.runtime import ServeEngine

TOL = 1e-4
#: depth variants: reduced() as it is, and 5 layers (a one-layer tail)
DEPTHS = {"reduced": {}, "tail": {"num_layers": 5}}
N_BRANCHES = 4
STEPS = 6
PROMPT = np.random.default_rng(11).integers(0, 256, (1, 19))


def configs(depth="reduced", **kw):
    """The reduced zamba2-7b from both packages, at float32."""
    kw = {"dtype": "float32", **DEPTHS[depth], **kw}
    return (dataclasses.replace(reduced(get_config("zamba2-7b")), **kw),
            dataclasses.replace(port_reduced(port_config("zamba2-7b")),
                                **kw))


@functools.lru_cache(maxsize=None)
def reference(depth):
    """The JAX model at ``depth`` and its weights (jax, numpy)."""
    jcfg, _ = configs(depth)
    jmodel = JaxModel(jcfg, attn_chunk=8, remat=False)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    return jmodel, jparams, jax.tree_util.tree_map(np.asarray, jparams)


def shapes(tree):
    return {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)
                                      .replace("torch.", ""))
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_config_copy_and_size():
    full = port_config("zamba2-7b")
    assert dataclasses.asdict(full) == dataclasses.asdict(
        get_config("zamba2-7b"))
    assert full.param_count() == get_config("zamba2-7b").param_count()
    assert round(full.param_count() / 1e9, 2) == 6.78
    # 13 shared applications, each with its own K/V: 182 KiB a token
    assert full.n_attn_layers == 13 and full.head_dim == 112
    assert full.kv_bytes_per_token() == 182 * 1024
    assert dataclasses.asdict(port_reduced(full)) == \
        dataclasses.asdict(reduced(get_config("zamba2-7b")))
    _, tail = configs("tail")
    assert tail.num_layers % tail.attn_every == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth", list(DEPTHS))
def test_port_init_has_the_reference_layout(depth, dtype):
    jcfg, pcfg = configs(depth, dtype=dtype)
    jparams = jax.eval_shape(JaxModel(jcfg).init, jax.random.PRNGKey(0))
    pparams = Model(pcfg).init(torch.Generator().manual_seed(0))
    assert shapes(pparams) == shapes(jparams)
    assert pparams["shared"]["w_concat"].shape == (2 * pcfg.d_model,
                                                   pcfg.d_model)


@pytest.mark.parametrize("depth", list(DEPTHS))
def test_bridge_takes_the_reference_tree(depth):
    weights = reference(depth)[2]
    pparams = params_from_jax(weights, device="cpu")
    assert shapes(pparams) == shapes(weights)
    bad = jax.tree_util.tree_map(np.copy, weights)
    del bad["shared"]["w_concat"]
    with pytest.raises(NotImplementedError, match="w_concat"):
        params_from_jax(bad, device="cpu")


@pytest.mark.parametrize("depth", list(DEPTHS))
def test_decode_state_specs_match_the_reference(depth, monkeypatch):
    jcfg, pcfg = configs(depth)
    jstate = JaxModel(jcfg).init_decode_state(3, 10)
    pstate = Model(pcfg).init_decode_state(3, 10, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in pstate.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in jstate.items()}
    assert pstate["k"].shape[0] == pcfg.num_layers // pcfg.attn_every
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):   # no silent CPU
        Model(pcfg).init_decode_state(3, 10)


@pytest.mark.parametrize("pos_form", ["vector", "scalar"])
@pytest.mark.parametrize("depth", list(DEPTHS))
def test_prefill_and_decode_match_jax(depth, pos_form):
    """Prefill of a 2 x 9 prompt into a 13-position cache: logits and
    every cache leaf; then four decode steps: logits every step, every
    leaf after the last."""
    jcfg, pcfg = configs(depth)
    jmodel, jparams, weights = reference(depth)
    pparams = params_from_jax(weights, device="cpu")
    pmodel = Model(pcfg)
    rng = np.random.default_rng(len(depth))
    b, s, steps = 2, 9, 4
    tokens = rng.integers(0, jcfg.vocab_size, (b, s))
    jl, jc = jmodel.prefill(jparams, jnp.asarray(tokens), max_len=s + steps)
    pl, pc = pmodel.prefill(pparams, torch.from_numpy(tokens),
                            max_len=s + steps)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    assert set(pc) == set(jc) == {"conv", "ssm", "k", "v"}
    for n in jc:
        np.testing.assert_allclose(pc[n].numpy(), np.asarray(jc[n]),
                                   rtol=TOL, atol=TOL, err_msg=n)
    for t in range(steps):
        tok = rng.integers(0, jcfg.vocab_size, (b, 1))
        jpos = (jnp.int32(s + t) if pos_form == "scalar"
                else jnp.full((b,), s + t, jnp.int32))
        ppos = (torch.tensor(s + t) if pos_form == "scalar"
                else torch.full((b,), s + t))
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(tok), jpos)
        pl, pc = pmodel.decode_step(pparams, pc, torch.from_numpy(tok), ppos)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL, err_msg=f"step {t}")
    for n in jc:
        np.testing.assert_allclose(pc[n].numpy(), np.asarray(jc[n]),
                                   rtol=TOL, atol=TOL, err_msg=n)


# ---------------------------------------------------------------------------
# the branching cycle: Model.prefill -> BranchStore -> fork -> batched
# decode -> first-commit-wins, in both packages
# ---------------------------------------------------------------------------

def jax_cycle(model, params, prompt):
    store = JaxStore()
    pos = prompt.shape[1]
    logits, cache = model.prefill(params, jnp.asarray(prompt, jnp.int32),
                                  max_len=pos + STEPS)
    store.snapshot_pytree(store.ROOT, cache)
    kids = store.fork(store.ROOT, N_BRANCHES)
    logp0 = jax.nn.log_softmax(logits[0, -1])
    first = np.argsort(-np.asarray(logp0), kind="stable")[:N_BRANCHES]
    toks = [[int(t)] for t in first]
    score = [float(logp0[t]) for t in first]
    for _ in range(STEPS):
        caches = [store.restore_pytree(k, cache) for k in kids]
        batch = {n: jnp.concatenate([c[n] for c in caches], axis=1)
                 for n in cache}
        last = jnp.asarray([[t[-1]] for t in toks], jnp.int32)
        logits, new = model.decode_step(params, batch, last,
                                        jnp.full((N_BRANCHES,), pos))
        pos += 1
        logp = jax.nn.log_softmax(logits[:, -1], axis=-1)
        for i, k in enumerate(kids):
            store.write_many(k, store.flatten_pytree(
                {n: v[:, i:i + 1] for n, v in new.items()}))
            t = int(jnp.argmax(logp[i]))
            toks[i].append(t)
            score[i] += float(logp[i, t])
    winner = int(np.argmax(score))
    store.commit(kids[winner])
    stale = []
    for k in kids:
        try:
            store.read(k, "['k']")
            stale.append(False)
        except JaxStale:
            stale.append(True)
    state = {n: np.asarray(v) for n, v in
             store.restore_pytree(store.ROOT, cache).items()}
    return toks, winner, [store.status(k).value for k in kids], stale, state


def port_cycle(model, params, prompt):
    store = BranchStore()
    pos = prompt.shape[1]
    logits, cache = model.prefill(params, torch.from_numpy(prompt),
                                  max_len=pos + STEPS)
    store.snapshot_pytree(store.ROOT, cache)
    kids = store.fork(store.ROOT, N_BRANCHES)
    logp0 = torch.log_softmax(logits[0, -1], dim=-1)
    first = np.argsort(-logp0.numpy(), kind="stable")[:N_BRANCHES]
    toks = [[int(t)] for t in first]
    score = [float(logp0[t]) for t in first]
    for _ in range(STEPS):
        caches = [store.restore_pytree(k, cache) for k in kids]
        # a new batch tensor: the step writes the shared block's K/V into
        # it, never into a restored (shared) leaf
        batch = {n: torch.cat([c[n] for c in caches], dim=1) for n in cache}
        last = torch.tensor([[t[-1]] for t in toks])
        logits, new = model.decode_step(params, batch, last,
                                        torch.full((N_BRANCHES,), pos))
        pos += 1
        logp = torch.log_softmax(logits[:, -1], dim=-1)
        for i, k in enumerate(kids):
            store.write_many(k, store.flatten_pytree(
                {n: v[:, i:i + 1].clone() for n, v in new.items()}))
            t = int(logp[i].argmax())
            toks[i].append(t)
            score[i] += float(logp[i, t])
    # the batched steps wrote nothing the siblings read: all readable
    for k in kids:
        assert set(store.restore_pytree(k, cache)) == set(cache)
    winner = int(np.argmax(score))
    store.commit(kids[winner])
    stale = []
    for k in kids:
        try:
            store.read(k, "['k']")
            stale.append(False)
        except StaleBranchError:
            stale.append(True)
    state = {n: v.numpy() for n, v in
             store.restore_pytree(store.ROOT, cache).items()}
    statuses = [store.status(k).value for k in kids]
    assert sum(store.reap(k) for k in kids) == N_BRANCHES   # all resolved
    return toks, winner, statuses, stale, state


@pytest.fixture(scope="module", params=list(DEPTHS))
def runs(request):
    jmodel, jparams, weights = reference(request.param)
    _, pcfg = configs(request.param)
    return (jax_cycle(jmodel, jparams, PROMPT),
            port_cycle(Model(pcfg), params_from_jax(weights, device="cpu"),
                       PROMPT))


def test_cycle_tokens_winner_and_statuses_identical(runs):
    (jt, jw, jstatus, jstale, _), (pt, pw, pstatus, pstale, _) = runs
    assert pt == jt
    assert pw == jw
    assert pstatus == jstatus == ["stale" if i != jw else "committed"
                                  for i in range(N_BRANCHES)]
    assert pstale == jstale == [i != jw for i in range(N_BRANCHES)]
    assert len({t[0] for t in pt}) == N_BRANCHES


def test_cycle_committed_root_state_matches(runs):
    (*_, jstate), (*_, pstate) = runs
    assert set(pstate) == set(jstate) == {"conv", "ssm", "k", "v"}
    for n in jstate:
        assert pstate[n].shape == jstate[n].shape
        np.testing.assert_allclose(pstate[n], jstate[n], rtol=TOL, atol=TOL)


def test_stepping_a_restored_cache_in_place_is_refused():
    """A single branch stepped on its restored cache, not batched by
    ``torch.cat`` nor cloned: the step writes its K/V row into the leaves
    ROOT and the sibling share, so the store refuses their next read.
    ``conv``/``ssm`` were stepped out of place and stay readable."""
    _, _, weights = reference("reduced")
    _, pcfg = configs()
    model = Model(pcfg)
    params = params_from_jax(weights, device="cpu")
    store = BranchStore()
    s = PROMPT.shape[1]
    logits, cache = model.prefill(params, torch.from_numpy(PROMPT),
                                  max_len=s + 2)
    store.snapshot_pytree(store.ROOT, cache)
    a, b = store.fork(store.ROOT, 2)
    restored = store.restore_pytree(a, cache)
    model.decode_step(params, restored, logits[:, -1].argmax(-1)[:, None],
                      torch.full((1,), s))
    for leaf in ("['conv']", "['ssm']"):
        store.read(b, leaf)
    for leaf in ("['k']", "['v']"):
        with pytest.raises(BranchStateError, match="written in place"):
            store.read(b, leaf)


def test_hybrid_model_builds_and_the_engine_refuses_it():
    """The hybrid runs through Model and BranchStore; the paged engine
    refuses it, as the JAX package's engine does."""
    _, pcfg = configs()
    jmodel, jparams, weights = reference("reduced")
    with pytest.raises(NotImplementedError, match="hybrid"):
        ServeEngine(Model(pcfg), params_from_jax(weights, device="cpu"),
                    device="cpu")
    with pytest.raises(AssertionError):
        jax_serve.ServeEngine(jmodel, jparams)
