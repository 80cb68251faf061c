"""Port parity: ``BranchStore`` and ``explore`` against the JAX package's.

The same seeded random sequence of fork / write / read / delete / commit /
abort / reap (nested forks included) runs on both stores; every step must
give the same result, or an error of the same class and errno, and the
same ``listdir``, ``delta_size`` and statuses.  Then Listing 2 (``explore``
with ``threads=False``), the pytree key paths, and the probe the SSM path
depends on: siblings decoding from one snapshot leave the parent's
tensors untouched, since the store shares them by reference.
"""

import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from repro.core import store as jax_store
from repro.core.errors import BranchError as JaxBranchError
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.core import store as port_store
from repro_torch.core.errors import BranchError
from repro_torch.models import Model

PATHS = ["a", "b", "c", "d/e"]


def outcome(fn):
    """A call's result, or (error class name, errno) when it raises."""
    try:
        out = fn()
    except (BranchError, JaxBranchError) as e:
        return ("error", type(e).__name__, int(e.errno))
    if hasattr(out, "value") and not isinstance(out, int):
        return out.value              # BranchStatus
    return out


def random_ops(seed, n_ops=400):
    """One op per step, chosen from the branch ids the run has made so
    far; both stores hand out the same ids in the same order."""
    rng = random.Random(seed)
    ids = [0]
    for _ in range(n_ops):
        op = rng.choice(["fork", "fork", "write", "write", "write", "read",
                         "read", "delete", "commit", "abort", "reap",
                         "listdir", "delta_size", "status"])
        # ROOT is the base: it is forked, written and read, never resolved
        pool = ids[1:] if op in ("commit", "abort", "reap") else ids
        if not pool:
            op, pool = "fork", ids
        yield op, rng.choice(pool), rng.choice(PATHS), rng.randrange(100), \
            rng.randrange(1, 4), ids


def apply(store, op, bid, path, value, n):
    return outcome({
        "fork": lambda: store.fork(bid, n),
        "write": lambda: store.write(bid, path, value),
        "read": lambda: store.read(bid, path),
        "delete": lambda: store.delete(bid, path),
        "commit": lambda: store.commit(bid),
        "abort": lambda: store.abort(bid),
        "reap": lambda: store.reap(bid),
        "listdir": lambda: store.listdir(bid),
        "delta_size": lambda: store.delta_size(bid),
        "status": lambda: store.status(bid),
    }[op])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_op_sequence_matches_the_reference(seed):
    base = {"a": 1, "b": 2}
    jst, pst = jax_store.BranchStore(base), port_store.BranchStore(base)
    forks = errors = 0
    for op, bid, path, value, n, ids in random_ops(seed):
        got = apply(pst, op, bid, path, value, n)
        want = apply(jst, op, bid, path, value, n)
        assert got == want, (op, bid, path)
        if op == "fork" and isinstance(got, list):
            ids.extend(got)
            forks += 1
        errors += isinstance(got, tuple)
        for b in ids:
            assert outcome(lambda: pst.status(b)) == \
                outcome(lambda: jst.status(b))
    for b in ids:
        for fn in ("listdir", "delta_size", "chain_depth"):
            assert outcome(lambda: getattr(pst, fn)(b)) == \
                outcome(lambda: getattr(jst, fn)(b))
    assert forks > 20 and errors > 20       # the run reached both sides


@pytest.mark.parametrize("votes", [(False, True, True, False),
                                   (False, False, False)], ids=str)
def test_explore_listing2_matches_the_reference(votes):
    results = []
    for mod in (jax_store, port_store):
        st = mod.BranchStore({"x": 0})

        def fn(i):
            def run(bid):
                st.write(bid, "x", i)
                return votes[i]
            return run

        winner, statuses = mod.explore(st, 0, [fn(i) for i in
                                               range(len(votes))],
                                       threads=False)
        results.append((winner, [s.value for s in statuses],
                        st.read(0, "x")))
    assert results[0] == results[1]


def test_pytree_paths_are_the_reference_key_strings():
    tree = {"ssm": torch.zeros(2), "conv": {"w": [torch.ones(1), 3]}}
    flat = port_store.BranchStore.flatten_pytree(tree, "req/")
    jflat = jax_store.BranchStore.flatten_pytree(
        jax.tree_util.tree_map(np.asarray, tree), "req/")
    assert sorted(flat) == sorted(jflat)
    st = port_store.BranchStore()
    st.snapshot_pytree(0, tree, "req/")
    back = st.restore_pytree(0, tree, "req/")
    assert back["ssm"] is tree["ssm"] and back["conv"]["w"][1] == 3


def test_siblings_decoding_leave_root_untouched():
    """Four siblings of one snapshot each decode 6 tokens: ROOT's leaves
    keep their bits and their storage."""
    cfg = dataclasses.replace(reduced(get_config("mamba2-2.7b")),
                              dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 11)))
    logits, cache = model.prefill(params, tokens)
    st = port_store.BranchStore()
    st.snapshot_pytree(st.ROOT, cache)
    root = {k: (v.clone(), v.data_ptr())
            for k, v in st.consolidated_view(st.ROOT).items()}
    kids = st.fork(st.ROOT, 4)
    for i, kid in enumerate(kids):
        tok = torch.tensor([[i]])
        for t in range(6):
            c = st.restore_pytree(kid, cache)
            logits, c = model.decode_step(params, c, tok,
                                          torch.tensor([11 + t]))
            st.snapshot_pytree(kid, c)
            tok = logits[:, -1].argmax(-1, keepdim=True)
    for k, (copy, ptr) in root.items():
        leaf = st.read(st.ROOT, k)
        assert leaf.data_ptr() == ptr and torch.equal(leaf, copy)
    assert len({st.read(k, "['ssm']").data_ptr() for k in kids}) == 4


def test_a_leaf_written_in_place_after_it_was_stored_is_refused():
    """The store shares tensors by reference, so it stamps each tensor
    leaf with its version counter: a write into it since (directly or
    through a view) makes its next read raise, on every branch that
    resolves to it.  A clone written back is a leaf of its own; a commit
    carries its stamp into the parent; non-tensor leaves and inference
    tensors are not checked."""
    st = port_store.BranchStore({"t": torch.zeros(4), "n": 3})
    kid, sib = st.fork(st.ROOT, 2)
    mine = st.read(kid, "t").clone()
    mine += 1
    st.write(kid, "t", mine)
    assert torch.equal(st.read(sib, "t"), torch.zeros(4))
    st.read(st.ROOT, "t")[1:2].fill_(7)       # through a view
    for branch in (st.ROOT, sib):
        with pytest.raises(port_store.BranchStateError, match="in place"):
            st.read(branch, "t")
    with pytest.raises(port_store.BranchStateError):
        st.consolidated_view(sib)
    assert torch.equal(st.read(kid, "t"), torch.ones(4))
    st.commit(kid)
    assert torch.equal(st.read(st.ROOT, "t"), torch.ones(4))
    assert st.read(st.ROOT, "n") == 3
    with torch.inference_mode():
        frozen = torch.zeros(2)
    st.write(st.ROOT, "i", frozen)
    assert st.read(st.ROOT, "i") is frozen


def test_a_dense_cache_stepped_in_place_is_refused_and_a_clone_is_not():
    """The dense ``decode_step`` writes the token's K/V row into the cache
    it is given.  A branch that steps a clone of its restored cache leaves
    its sibling's view as snapshotted; one that steps the restored tensors
    themselves writes into the snapshot the siblings share, and their next
    read raises instead of handing it out."""
    cfg = dataclasses.replace(reduced(get_config("granite-8b")),
                              dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 7)))
    logits, cache = model.prefill(params, tokens, max_len=12)
    snap = {k: v.clone() for k, v in cache.items()}
    st = port_store.BranchStore()
    st.snapshot_pytree(st.ROOT, cache)
    del cache
    a, b = st.fork(st.ROOT, 2)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    mine = {k: v.clone() for k, v in st.restore_pytree(a, snap).items()}
    _, mine = model.decode_step(params, mine, tok, torch.tensor([7]))
    st.snapshot_pytree(a, mine)
    theirs = st.restore_pytree(b, snap)
    assert all(torch.equal(theirs[k], snap[k]) for k in snap)
    assert not torch.equal(st.read(a, "['k']"), snap["k"])
    model.decode_step(params, theirs, tok, torch.tensor(7))
    for branch in (st.ROOT, b):
        with pytest.raises(port_store.BranchStateError, match="in place"):
            st.restore_pytree(branch, snap)
    assert not torch.equal(st.read(a, "['k']"), snap["k"])
