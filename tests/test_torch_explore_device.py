"""Port parity: device-side exploration (``repro_torch.core.explore``, over
``torch.func.vmap``) against the JAX package's ``repro.core.explore``
(``jax.vmap``), and the two packages' ``core`` exports.

The scenarios are those of ``tests/test_explore_device.py``.  Step
functions that draw nothing are held exactly against the reference on the
same inputs.  The two packages draw from different random streams (JAX
keys against the port's counter-based keys), so random step functions are
held by their invariants: the winner is the argmin of ``aux``, the
committed state is the winner's, and the reference's gradient-descent
scenario converges.  The port's keys themselves are checked for what the
scenarios rely on: distinct per branch, reproducible from a seed, and the
same bits from the same key on any device.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro_torch.core as port_core
from repro.core import explore as jax_explore_fn

E = importlib.import_module("repro_torch.core.explore")


def test_core_exports_match_the_reference():
    # names of repro.core still unported: none
    unported = set()
    assert set(jax_core.__all__) - set(port_core.__all__) == unported
    assert port_core.__all__ == jax_core.__all__
    assert port_core.explore is E.explore
    assert port_core.explore_threads.__module__ == "repro_torch.core.store"
    from repro_torch.core.store import BranchStatus
    assert port_core.BranchStatus is BranchStatus


def test_fork_stacked_shapes():
    w = np.ones((3, 4), np.float32)
    jf = jax_core.fork_stacked({"w": jnp.asarray(w), "step": jnp.int32(7)}, 5)
    pf = E.fork_stacked({"w": torch.from_numpy(w),
                         "step": torch.tensor(7, dtype=torch.int32)}, 5)
    assert pf["w"].shape == jf["w"].shape == (5, 3, 4)
    assert pf["step"].shape == jf["step"].shape == (5,)
    np.testing.assert_array_equal(pf["w"][2].numpy(), w)
    np.testing.assert_array_equal(pf["step"].numpy(), np.asarray(jf["step"]))
    # a view: the fork copies nothing
    assert pf["w"].stride(0) == 0


@pytest.mark.parametrize("success, t, want", [
    ([False, True, True, False], [0.1, 0.5, 0.2, 0.0], 2),
    ([False, True, True], None, 1),            # default time = index
    ([False, False, False, False], None, None),
    ([True, True, True], [0.3, 0.3, 0.3], 0),  # ties to the lowest index
])
def test_first_commit_wins(success, t, want):
    jw, jok = jax_core.first_commit_wins(
        jnp.asarray(success), None if t is None else jnp.asarray(t))
    pw, pok = E.first_commit_wins(
        torch.tensor(success), None if t is None else torch.tensor(t))
    assert pw.dtype == torch.int32 and pw.dim() == 0
    assert (int(pw), bool(pok)) == (int(jw), bool(jok))
    if want is not None:
        assert int(pw) == want and bool(pok)
    else:
        assert not bool(pok)


def test_select_branch_dynamic_index():
    a = np.arange(12).reshape(3, 4)
    out = E.select_branch({"a": torch.from_numpy(a)},
                          torch.tensor(2, dtype=torch.int32))
    ref = jax.jit(jax_core.select_branch)({"a": jnp.asarray(a)},
                                          jnp.int32(2))
    np.testing.assert_array_equal(out["a"].numpy(), np.asarray(ref["a"]))
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(8, 12))


def test_explore_commits_winner():
    origin = {"x": torch.zeros(2), "loss": torch.tensor(100.0)}

    def step(state, key):
        # each branch proposes x = branch noise; success if loss improves
        noise = E.normal(key, (2,))
        new_loss = torch.sum(noise ** 2)
        return ({"x": noise, "loss": new_loss}, new_loss < state["loss"],
                new_loss)

    gen = torch.Generator().manual_seed(0)
    result = E.explore(step, origin, 4, gen, commit_time_fn=lambda aux: aux)
    assert bool(result.committed)
    # winner is the branch with the smallest loss (earliest "commit time")
    losses = result.aux.numpy()
    assert len(set(losses.tolist())) == 4          # branches drew apart
    assert int(result.winner) == int(np.argmin(losses))
    np.testing.assert_allclose(float(result.state["loss"]), losses.min(),
                               rtol=1e-6)
    np.testing.assert_allclose(float(torch.sum(result.state["x"] ** 2)),
                               losses.min(), rtol=1e-6)
    # the origin was never written
    assert float(origin["loss"]) == 100.0 and not origin["x"].any()


def test_explore_no_winner_keeps_origin():
    x = np.full((2,), 5.0, np.float32)

    def jstep(state, key):
        return {"x": state["x"] + 1}, jnp.bool_(False), jnp.float32(0)

    def pstep(state, key):
        return {"x": state["x"] + 1}, torch.tensor(False), torch.tensor(0.0)

    jres = jax_explore_fn(jstep, {"x": jnp.asarray(x)}, 3,
                          jax.random.PRNGKey(1))
    pres = E.explore(pstep, {"x": torch.from_numpy(x)}, 3, 1)
    assert not bool(pres.committed) and not bool(jres.committed)
    assert int(pres.winner) == int(jres.winner) == 0
    np.testing.assert_array_equal(pres.state["x"].numpy(), x)
    np.testing.assert_array_equal(pres.state["x"].numpy(),
                                  np.asarray(jres.state["x"]))
    np.testing.assert_array_equal(pres.aux.numpy(), np.asarray(jres.aux))


def test_explore_deterministic_step_matches_the_reference():
    """A step that draws nothing commits the same branch and state in
    both packages."""
    x0 = np.linspace(-1.0, 2.0, 6, dtype=np.float32).reshape(2, 3)

    def make(lib):
        def step(state, key):
            new = state["x"] * 0.5 + 1.0
            loss = lib.sum((new - 1.2) ** 2)
            return {"x": new, "n": state["n"] + 1}, loss < 3.0, loss
        return step

    def perturb_j(s, key, i):
        return {"x": s["x"] * (i.astype(jnp.float32) - 1.0), "n": s["n"]}

    def perturb_p(s, key, i):
        return {"x": s["x"] * (i.to(torch.float32) - 1.0), "n": s["n"]}

    jres = jax_explore_fn(make(jnp),
                          {"x": jnp.asarray(x0), "n": jnp.int32(0)}, 4,
                          jax.random.PRNGKey(0), perturb_fn=perturb_j,
                          commit_time_fn=lambda a: a)
    pres = E.explore(make(torch),
                     {"x": torch.from_numpy(x0),
                      "n": torch.tensor(0, dtype=torch.int32)}, 4, 0,
                     perturb_fn=perturb_p, commit_time_fn=lambda a: a)
    assert bool(pres.committed) == bool(jres.committed)
    assert int(pres.winner) == int(jres.winner)
    np.testing.assert_allclose(pres.aux.numpy(), np.asarray(jres.aux),
                               rtol=1e-6)
    np.testing.assert_allclose(pres.state["x"].numpy(),
                               np.asarray(jres.state["x"]), rtol=1e-6)
    assert int(pres.state["n"]) == int(jres.state["n"]) == 1


def test_perturbed_fork_distinct_branches():
    def jperturb(s, key, i):
        return {"lr": s["lr"] * (2.0 ** i.astype(jnp.float32))}

    def pperturb(s, key, i):
        return {"lr": s["lr"] * (2.0 ** i.to(torch.float32))}

    jf = jax_core.perturbed_fork({"lr": jnp.float32(1.0)}, 3, jperturb,
                                 jax.random.PRNGKey(0))
    pf = E.perturbed_fork({"lr": torch.tensor(1.0)}, 3, pperturb,
                          torch.Generator().manual_seed(0))
    np.testing.assert_allclose(pf["lr"].numpy(), [1.0, 2.0, 4.0])
    np.testing.assert_array_equal(pf["lr"].numpy(), np.asarray(jf["lr"]))


def test_explore_gradient_descent_converges():
    """End-to-end: exploration as a training primitive (speculative
    steps), with ``torch.func.grad`` inside the vmap."""

    def loss_fn(x):
        return torch.sum((x - 3.0) ** 2)

    def step(state, key):
        g = torch.func.grad(loss_fn)(state["x"])
        lr = 0.1 + 0.2 * E.uniform(key)   # each branch tries an LR
        new_x = state["x"] - lr * g
        improved = loss_fn(new_x) < loss_fn(state["x"])
        return {"x": new_x}, improved, loss_fn(new_x)

    state = {"x": torch.zeros(4)}
    gen = torch.Generator().manual_seed(42)
    for _ in range(25):
        res = E.explore(step, state, 4, gen, commit_time_fn=lambda a: a)
        assert int(res.winner) == int(torch.argmin(res.aux))
        state = res.state
    assert float(loss_fn(state["x"])) < 1e-3


def test_keys_are_distinct_reproducible_and_device_free():
    key = E.key_from(7)
    assert key.dtype == torch.int64 and key.shape == (2,)
    assert torch.equal(key, E.key_from(7))
    keys = E.split(key, 64)
    assert len({tuple(k) for k in keys.tolist()}) == 64
    assert not torch.equal(E.fold_in(key, 0), E.fold_in(key, 1))
    u = E.uniform(key, (4096,))
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02
    z = E.normal(key, (4096,))
    assert abs(float(z.mean())) < 0.06 and abs(float(z.std()) - 1.0) < 0.06
    # integer hashing pins the bits: chip_smoke.py draws the same values
    # from the same keys on the card
    assert E.split(torch.tensor([123456789, 987654321]), 2).tolist() == [
        [2787185960, 2645212397], [1654727664, 1604174573]]
    assert E.uniform(torch.tensor([1, 2]), (2,)).tolist() == [
        0.10696852207183838, 0.7602502703666687]
    per_branch = torch.func.vmap(lambda k: E.uniform(k, (3,)))(keys[:4])
    assert torch.equal(per_branch[1], E.uniform(keys[1], (3,)))
