"""Port parity: fault tolerance as branch semantics, and the speculative
trainer.

The six scenarios of ``tests/test_fault_tolerance.py`` on the port's
``FaultTolerantTrainer`` (NaN rollback, checkpoint/restart replaying the
exact stream, straggler racing with first-commit-wins, a dead executor),
then ``SpeculativeTrainer`` against the reference's: at
``lr_scale_steps=1`` every branch's multiplier is the base, so the draw
(threefry there, the port's counter-based keys here) does not matter, and
both start from one bridged state on the same numpy batches: the
validation losses agree within 1e-5 relative (float32 on both sides,
different summation orders).  With several multipliers the winner is the
argmin of the validation losses, and when every branch diverges the origin
is kept, bit for bit.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_config as jax_config
from repro.configs.base import reduced as jax_reduced
from repro.explore_ctx import SpeculativeTrainer as JaxSpeculativeTrainer
from repro.models.model import Model as JaxModel
from repro.optim import adamw as jax_adamw
from repro_torch.bridge import train_state_from_jax
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.serialization import flatten_with_path
from repro_torch.configs import get_config, reduced
from repro_torch.core.lifecycle import BranchStatus
from repro_torch.data import SyntheticLMPipeline
from repro_torch.explore_ctx import SpeculativeTrainer
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.runtime.fault import FaultTolerantTrainer
from repro_torch.runtime.train_loop import build_train_step, init_train_state


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(reduced(get_config("qwen2-1.5b")),
                              dtype="float32")
    model = Model(cfg, attn_chunk=8, loss_chunk=8, remat=False)
    opt = adamw(1e-3)
    step = build_train_step(model, opt)
    state = init_train_state(model, opt,
                             torch.Generator().manual_seed(0))
    return cfg, model, opt, step, state


def make_trainer(setup, tmp_path=None, **kw):
    cfg, model, opt, step, state = setup
    data = SyntheticLMPipeline(cfg, batch=2, seq=16, seed=3, device="cpu")
    ckpt = CheckpointManager(tmp_path / "ckpt") if tmp_path else None
    return FaultTolerantTrainer(step_fn=step, state=state, data=data,
                                ckpt=ckpt, **kw)


def test_loss_decreases(setup):
    tr = make_trainer(setup)
    log = tr.run(12)
    assert len(log) == 12
    assert log[-1]["loss"] < log[0]["loss"]


def test_nan_rollback_skips_bad_step(setup):
    tr = make_trainer(setup, corrupt_loss_at=3)
    tr.run(3)
    before = [x for _, x in flatten_with_path(tr.committed_state)]
    copies = [x.clone() for x in before]
    tr.run(5)
    assert tr.rollbacks == 1
    assert len(tr.metrics_log) == 7          # one step rolled back
    assert all(np.isfinite(m["loss"]) for m in tr.metrics_log)
    assert int(tr.committed_state.step) == 7
    # the rolled-back step never touched the state it started from
    assert all(torch.equal(a, b) for a, b in zip(before, copies))


def test_checkpoint_restart_resumes_exact_stream(setup, tmp_path):
    cfg, model, opt, step, state = setup
    tr = make_trainer(setup, tmp_path, ckpt_every=5)
    tr.run(10)

    # simulate a crash: rebuild everything from the checkpoint
    data2 = SyntheticLMPipeline(cfg, batch=2, seq=16, seed=3, device="cpu")
    tr2 = FaultTolerantTrainer.restore(
        step, state, data2, CheckpointManager(tmp_path / "ckpt"))
    assert int(tr2.state.step) == 10
    assert tr2.data.state().step == 10      # data cursor replayed
    tr2.run(3)
    tr3 = make_trainer(setup)
    tr3.run(13)
    ref = [m["loss"] for m in tr3.metrics_log][10:]
    got = [m["loss"] for m in tr2.metrics_log]
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_straggler_speculation_first_commit_wins(setup):
    tr = make_trainer(setup)
    tr.run(1)
    res = tr.speculative_step(n_replicas=3, delays=[2.0, 0.0, 2.0])
    assert res["outcomes"].count("committed") == 1
    assert res["outcomes"][1] == "committed"
    assert res["outcomes"].count("stale") == 2
    assert res["statuses"].count(BranchStatus.COMMITTED) == 1


def test_straggler_speculation_with_dead_executor(setup):
    tr = make_trainer(setup)
    res = tr.speculative_step(n_replicas=2, delays=[0.0, 0.0],
                              kill=[True, False])
    assert res["outcomes"][0] == "killed"
    assert res["outcomes"][1] == "committed"
    assert res["statuses"][0] is BranchStatus.STALE


def test_speculation_then_training_continues(setup):
    tr = make_trainer(setup)
    tr.run(2)
    tr.speculative_step(n_replicas=2, delays=[0.05, 0.0])
    tr.run(2)
    assert int(tr.committed_state.step) == 5


# ---------------------------------------------------------------------------
# SpeculativeTrainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spec():
    jcfg = dataclasses.replace(jax_reduced(jax_config("qwen2-1.5b")),
                               dtype="float32")
    cfg = dataclasses.replace(reduced(get_config("qwen2-1.5b")),
                              dtype="float32")
    jm = JaxModel(jcfg, attn_chunk=8, loss_chunk=8)
    model = Model(cfg, attn_chunk=8, loss_chunk=8)
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, cfg.vocab_size, (2, 16)) for _ in range(2)]
    return jm, model, batches


def as_batch(toks, lib):
    if lib == "jax":
        t = jnp.asarray(toks, jnp.int32)
    else:
        t = torch.from_numpy(toks)
    return {"tokens": t, "targets": t}


def port_state(jstate):
    jstate = jax.tree_util.tree_map(np.asarray, jstate)
    st = train_state_from_jax(types.SimpleNamespace(
        params=jstate["params"], opt_state=jstate["opt"], ef=None,
        step=np.int32(0)), device="cpu")
    return {"params": st.params, "opt": st.opt_state}


def test_speculative_trainer_matches_the_reference(spec):
    jm, model, batches = spec
    jt = JaxSpeculativeTrainer(jm, jax_adamw(1e-2), n_branches=3,
                               lr_scale_steps=1)
    pt = SpeculativeTrainer(model, adamw(1e-2), n_branches=3,
                            lr_scale_steps=1)
    js = jt.init(jax.random.PRNGKey(0))
    state = port_state(js)
    for i in range(2):
        js, jinfo = jt.step(js, jax.random.PRNGKey(i),
                            as_batch(batches[0], "jax"),
                            as_batch(batches[1], "jax"))
        state, info = pt.step(state, i, as_batch(batches[0], "torch"),
                              as_batch(batches[1], "torch"))
        np.testing.assert_allclose(info["val_losses"], jinfo["val_losses"],
                                   rtol=1e-5)
        assert info["winner"] == jinfo["winner"] == 0   # equal: index order
        assert info["committed"] and jinfo["committed"]


def test_speculative_winner_is_the_argmin(spec):
    _, model, batches = spec
    pt = SpeculativeTrainer(model, adamw(1e-2), n_branches=4,
                            lr_scale_base=0.25, lr_scale_steps=4)
    state = pt.init(torch.Generator().manual_seed(0))
    new, info = pt.step(state, 3, as_batch(batches[0], "torch"),
                        as_batch(batches[1], "torch"))
    assert len(set(info["val_losses"])) > 1       # the multipliers differ
    assert info["winner"] == int(np.argmin(info["val_losses"]))
    assert info["committed"]
    val = model.loss(new["params"], as_batch(batches[1], "torch"))[0]
    assert float(val) == pytest.approx(min(info["val_losses"]), rel=1e-6)


def test_speculative_all_diverged_keeps_the_origin(spec):
    _, model, batches = spec
    pt = SpeculativeTrainer(model, adamw(1e-2), n_branches=2,
                            lr_scale_base=float("nan"), lr_scale_steps=1)
    state = pt.init(torch.Generator().manual_seed(0))
    new, info = pt.step(state, 0, as_batch(batches[0], "torch"),
                        as_batch(batches[1], "torch"))
    assert not info["committed"]
    assert not any(np.isfinite(info["val_losses"]))
    for a, b in zip(pytree.tree_leaves(new), pytree.tree_leaves(state)):
        assert torch.equal(a, b)
