"""Port parity: the SSM family's branched serving cycle against JAX.

The cycle is the JAX package's SSM serving path (DESIGN §6), which has no
engine: ``Model.prefill`` gives the recurrent-state cache, ROOT of a
``BranchStore`` snapshots it, ``fork`` makes 4 branches whose first tokens
are the prefill's 4 best, 6 greedy steps decode all branches as one batch
(their ``[L, 1, ...]`` states stacked on the batch dim, each slice written
back to its branch as a tensor of its own), the branch with the highest
mean log-probability commits first and its siblings go stale.  Both
packages run it on ``reduced(mamba2-2.7b)`` at float32 from one set of
weights; tokens and statuses must be identical and the committed ROOT
state agree within 1e-4 (float32, different summation orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import reduced
from repro.core.errors import StaleBranchError as JaxStale
from repro.core.store import BranchStore as JaxStore
from repro.models.model import Model as JaxModel
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import reduced as port_reduced
from repro_torch.core import BranchStore, StaleBranchError
from repro_torch.models import Model

TOL = 1e-4
N_BRANCHES = 4
STEPS = 6
PROMPT = np.random.default_rng(7).integers(0, 256, (1, 19))


def jax_cycle(model, params, prompt):
    store = JaxStore()
    logits, cache = model.prefill(params, jnp.asarray(prompt, jnp.int32))
    store.snapshot_pytree(store.ROOT, cache)
    kids = store.fork(store.ROOT, N_BRANCHES)
    logp0 = jax.nn.log_softmax(logits[0, -1])
    first = np.argsort(-np.asarray(logp0), kind="stable")[:N_BRANCHES]
    toks = [[int(t)] for t in first]
    score = [float(logp0[t]) for t in first]
    pos = prompt.shape[1]
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
            store.read(k, "['ssm']")
            stale.append(False)
        except JaxStale:
            stale.append(True)
    state = {n: np.asarray(v) for n, v in
             store.restore_pytree(store.ROOT, cache).items()}
    return toks, winner, [store.status(k).value for k in kids], stale, state


def port_cycle(model, params, prompt):
    store = BranchStore()
    logits, cache = model.prefill(params, torch.from_numpy(prompt))
    store.snapshot_pytree(store.ROOT, cache)
    kids = store.fork(store.ROOT, N_BRANCHES)
    logp0 = torch.log_softmax(logits[0, -1], dim=-1)
    first = np.argsort(-logp0.numpy(), kind="stable")[:N_BRANCHES]
    toks = [[int(t)] for t in first]
    score = [float(logp0[t]) for t in first]
    pos = prompt.shape[1]
    for _ in range(STEPS):
        caches = [store.restore_pytree(k, cache) for k in kids]
        batch = {n: torch.cat([c[n] for c in caches], dim=1) for n in cache}
        last = torch.tensor([[t[-1]] for t in toks])
        logits, new = model.decode_step(params, batch, last,
                                        torch.full((N_BRANCHES,), pos))
        pos += 1
        logp = torch.log_softmax(logits[:, -1], dim=-1)
        for i, k in enumerate(kids):
            # a tensor of its own: a view would keep the batch alive and
            # alias the siblings
            store.write_many(k, store.flatten_pytree(
                {n: v[:, i:i + 1].clone() for n, v in new.items()}))
            t = int(logp[i].argmax())
            toks[i].append(t)
            score[i] += float(logp[i, t])
    winner = int(np.argmax(score))
    store.commit(kids[winner])
    stale = []
    for k in kids:
        try:
            store.read(k, "['ssm']")
            stale.append(False)
        except StaleBranchError:
            stale.append(True)
    state = {n: v.numpy() for n, v in
             store.restore_pytree(store.ROOT, cache).items()}
    statuses = [store.status(k).value for k in kids]
    assert sum(store.reap(k) for k in kids) == N_BRANCHES   # all resolved
    return toks, winner, statuses, stale, state


@pytest.fixture(scope="module")
def runs():
    jcfg = dataclasses.replace(reduced(get_config("mamba2-2.7b")),
                               dtype="float32")
    pcfg = dataclasses.replace(port_reduced(port_config("mamba2-2.7b")),
                               dtype="float32")
    jmodel = JaxModel(jcfg, remat=False)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    weights = jax.tree_util.tree_map(np.asarray, jparams)
    return (jax_cycle(jmodel, jparams, PROMPT),
            port_cycle(Model(pcfg), params_from_jax(weights, device="cpu"),
                       PROMPT))


def test_tokens_winner_and_statuses_identical(runs):
    (jt, jw, jstatus, jstale, _), (pt, pw, pstatus, pstale, _) = runs
    assert pt == jt
    assert pw == jw
    assert pstatus == jstatus == ["stale" if i != jw else "committed"
                                  for i in range(N_BRANCHES)]
    assert pstale == jstale == [i != jw for i in range(N_BRANCHES)]
    # the branches really diverged: distinct first tokens, then greedy
    assert len({t[0] for t in pt}) == N_BRANCHES


def test_committed_root_state_matches(runs):
    (*_, jstate), (*_, pstate) = runs
    assert set(pstate) == set(jstate) == {"conv", "ssm"}
    for n in jstate:
        assert pstate[n].shape == jstate[n].shape
        np.testing.assert_allclose(pstate[n], jstate[n], rtol=TOL, atol=TOL)
