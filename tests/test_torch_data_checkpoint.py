"""Port parity: the synthetic data pipeline and the checkpoint manager.

Every case of ``tests/test_data_checkpoint.py`` on the port, then the
shared checkpoint format: a checkpoint the JAX package wrote restores in
the port and the reverse, with bit-identical leaves (bf16 included) and
the same ``tree_paths``, for a plain tree and for a whole ``TrainState``.
The port's batches come from its counter-based keys, not threefry, so they
are held to the reference's properties (shapes, dtypes, shifted targets,
the bigram structure, replay, disjoint shards), not to its bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.checkpoint import tree_paths as jax_tree_paths
from repro.configs import get_config as jax_config
from repro.configs.base import reduced as jax_reduced
from repro.models.model import Model as JaxModel
from repro.optim import adamw as jax_adamw
from repro.runtime.train_loop import init_train_state as jax_init
from repro_torch.bridge import train_state_from_jax
from repro_torch.checkpoint import CheckpointManager, tree_paths
from repro_torch.checkpoint.serialization import (
    flatten_with_path,
    leaf_from_bytes,
    leaf_to_bytes,
)
from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticLMPipeline


@pytest.fixture
def cfg():
    return reduced(get_config("granite-8b"))


def pipe(cfg, **kw):
    return SyntheticLMPipeline(cfg, **{"batch": 2, "seq": 16, "seed": 7,
                                       "device": "cpu", **kw})


def test_pipeline_deterministic_replay(cfg):
    p1 = pipe(cfg)
    [p1.next() for _ in range(3)]
    state = p1.state()
    more = [p1.next() for _ in range(2)]
    p2 = SyntheticLMPipeline.from_state(cfg, 2, 16, state, device="cpu")
    replay = [p2.next() for _ in range(2)]
    for a, b in zip(more, replay):
        assert torch.equal(a["tokens"], b["tokens"])


def test_pipeline_shards_disjoint(cfg):
    a = pipe(cfg, shard=0, num_shards=2).next()
    b = pipe(cfg, shard=1, num_shards=2).next()
    assert not torch.equal(a["tokens"], b["tokens"])


def test_pipeline_targets_are_shifted_tokens(cfg):
    b0 = pipe(cfg, seed=0).next()
    assert torch.equal(b0["tokens"][:, 1:], b0["targets"][:, :-1])


def test_pipeline_codebooks():
    cfg = reduced(get_config("musicgen-medium"))
    b = SyntheticLMPipeline(cfg, batch=2, seq=8, device="cpu").next()
    assert b["tokens"].shape == (2, 8, cfg.num_codebooks)
    assert int(b["tokens"].max()) < cfg.vocab_size


def test_pipeline_same_batch_for_the_same_step_and_peek(cfg):
    p = pipe(cfg)
    first = p.next()
    assert torch.equal(pipe(cfg).peek(0)["tokens"], first["tokens"])
    assert not torch.equal(p.next()["tokens"], first["tokens"])


def test_pipeline_has_the_reference_structure(cfg):
    """Zipf unigram (token 0 most frequent at even positions), its image
    under ``t -> (7 t + 13) % V`` at odd positions (13 most frequent),
    int64 tokens in range, and the VLM stub's bf16 patches."""
    b = pipe(cfg, batch=64, seq=63).next()
    toks = torch.cat([b["tokens"], b["targets"][:, -1:]], dim=1)
    assert toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    v = cfg.vocab_size
    even = torch.bincount(toks[:, 0::2].reshape(-1), minlength=v)
    odd = torch.bincount(toks[:, 1::2].reshape(-1), minlength=v)
    assert int(even.argmax()) == 0 and even[0] > 4 * even[10]
    assert int(odd.argmax()) == 13 and odd[13] > 4 * odd[(7 * 10 + 13) % v]
    vlm = reduced(get_config("pixtral-12b"))
    fe = SyntheticLMPipeline(vlm, batch=2, seq=16, device="cpu").next()[
        "frontend_embed"]
    assert fe.shape == (2, vlm.frontend_tokens, vlm.d_model)
    assert fe.dtype == torch.bfloat16
    assert 0.8 < float(fe.float().std()) < 1.2


def test_pipeline_without_a_device_runs_on_the_card(cfg):
    if torch.cuda.is_available():
        assert pipe(cfg, device=None).next()["tokens"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pipe(cfg, device=None)


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def tree_example(scale=1.0):
    return {
        "params": {"w": torch.full((8, 8), scale, dtype=torch.bfloat16),
                   "b": torch.arange(4, dtype=torch.float32)},
        "opt": {"mu": torch.zeros((8, 8)),
                "step": torch.tensor(3, dtype=torch.int32)},
    }


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt")
    tree = tree_example()
    mgr.save(10, tree, extra={"data_step": 42})
    out = mgr.restore(tree)
    assert tree_paths(out) == tree_paths(tree)
    for a, b in zip(pytree.tree_leaves(tree), pytree.tree_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert mgr.restore_meta()["extra"]["data_step"] == 42


def test_checkpoint_async_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save_async(1, tree_example(1.0))
    mgr.save_async(2, tree_example(2.0))
    mgr.wait()
    assert mgr.latest_step() == 2
    assert mgr.steps() == [1, 2]
    out = mgr.restore(tree_example())
    assert float(out["params"]["w"][0, 0]) == 2.0


def test_delta_checkpoint_dedupes_unchanged_leaves(tmp_path):
    """Unchanged leaves between checkpoints share chunks on disk."""
    mgr = CheckpointManager(tmp_path / "ckpt")
    t1 = tree_example()
    mgr.save(1, t1)
    first = mgr.fs.chunks.stats()["chunks"]
    t2 = pytree.tree_map(lambda x: x, t1)
    t2["opt"]["step"] = torch.tensor(4, dtype=torch.int32)
    mgr.save(2, t2)
    added = mgr.fs.chunks.stats()["chunks"] - first
    assert added <= 3, f"delta checkpoint added {added} chunks"


def test_checkpoint_restore_specific_step(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(1, tree_example(1.0))
    mgr.save(2, tree_example(2.0))
    out = mgr.restore(tree_example(), step=1)
    assert float(out["params"]["w"][0, 0]) == 1.0


def test_bfloat16_serialization_roundtrip():
    x = torch.tensor([[1.5, -2.25], [0.0, 3.0]], dtype=torch.bfloat16)
    y = leaf_from_bytes(leaf_to_bytes(x))
    assert y.dtype == torch.bfloat16 and torch.equal(x, y)


def test_compressed_checkpoint(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt", compress=True)
    tree = tree_example()
    mgr.save(5, tree)
    out = mgr.restore(tree)
    assert torch.equal(out["params"]["b"], tree["params"]["b"])


# ---------------------------------------------------------------------------
# one format: either package restores the other's checkpoint
# ---------------------------------------------------------------------------

def jax_tree(tree):
    """The same tree in the JAX package: bf16 crossing as its bits."""
    def conv(x):
        if x.dtype == torch.bfloat16:
            bits = x.view(torch.int16).numpy().view(np.uint16)
            return jnp.asarray(bits.view(jnp.bfloat16))
        return jnp.asarray(x.numpy())
    return pytree.tree_map(conv, tree)


def assert_bits_equal(port_tree, jax_tree_):
    got = dict(flatten_with_path(port_tree))
    want = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jax_tree_)[0]}
    assert list(got) == list(want)
    for path, w in want.items():
        g = got[path]
        assert str(w.dtype) == str(g.dtype).replace("torch.", ""), path
        gb = (g.view(torch.int16).numpy() if g.dtype == torch.bfloat16
              else g.numpy())
        wb = w.view(np.int16) if str(w.dtype) == "bfloat16" else w
        np.testing.assert_array_equal(gb, wb, err_msg=path)


@pytest.mark.parametrize("compress", [False, True], ids=["raw", "zstd"])
def test_port_restores_a_reference_checkpoint(tmp_path, compress):
    tree = tree_example(1.5)
    JaxCheckpointManager(tmp_path / "ckpt", compress=compress).save(
        7, jax_tree(tree), extra={"data_step": 9})
    mgr = CheckpointManager(tmp_path / "ckpt")
    out = mgr.restore(tree_example())
    assert tree_paths(out) == jax_tree_paths(jax_tree(tree))
    assert_bits_equal(out, jax_tree(tree))
    assert mgr.restore_meta() == {"step": 7, "extra": {"data_step": 9}}


@pytest.mark.parametrize("compress", [False, True], ids=["raw", "zstd"])
def test_reference_restores_a_port_checkpoint(tmp_path, compress):
    tree = tree_example(2.5)
    mgr = CheckpointManager(tmp_path / "ckpt", compress=compress)
    mgr.save_async(3, tree, extra={"data_step": 4})
    mgr.wait()
    jmgr = JaxCheckpointManager(tmp_path / "ckpt")
    out = jmgr.restore(jax_tree(tree_example()))
    assert_bits_equal(tree, out)
    assert jmgr.restore_meta() == {"step": 3, "extra": {"data_step": 4}}


def test_train_state_checkpoint_crosses_both_ways(tmp_path):
    """A bf16 TrainState with AdamW moments and an int8 error-feedback
    residual: same paths (``.params['layers']['attn']['wq']``,
    ``.opt_state['mu']...``, ``.ef.residual...``, ``.step``), same bits."""
    jcfg = dataclasses.replace(jax_reduced(jax_config("qwen2-1.5b")),
                               dtype="bfloat16")
    js = jax_init(JaxModel(jcfg), jax_adamw(1e-3), jax.random.PRNGKey(0),
                  compress="int8")
    js = js._replace(opt_state={**js.opt_state, "step": jnp.int32(5)})
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, js),
                                 device="cpu")
    assert tree_paths(state) == jax_tree_paths(js)
    assert ".params['layers']['attn']['wq']" in tree_paths(state)
    assert ".opt_state['mu']['embed']" in tree_paths(state)
    JaxCheckpointManager(tmp_path / "a").save(5, js)
    assert_bits_equal(CheckpointManager(tmp_path / "a").restore(state), js)
    CheckpointManager(tmp_path / "b").save(5, state)
    assert_bits_equal(state, JaxCheckpointManager(tmp_path / "b").restore(js))
