"""Port: parameters, moments and gradients stored as blocks over a mesh on
the CPU (``distributed/blocked.py``), against the reference's layout and
the port's whole storage.

A leaf over a training plan is stored as the distinct blocks its
sanitized ``param_shardings`` spec names, each on the device of the first
mesh position holding it (a leaf the spec replicates is one plain tensor
on the mesh's first device).  The layout is held against the reference's
``addressable_shards`` (indices, shapes, and the first mesh position
holding each; ``devices_indices_map``, the index of each device's shard
of a placed array) on a ``(2, 4)`` and a ``(2, 2, 2)`` mesh, run once in
a subprocess with 8 forced host devices, as
``tests/test_torch_dist_train.py`` runs the reference's sharding rules.

Steps over blocked storage against the whole storage the port keeps
without ``shard_params`` (``tests/test_torch_train.py``'s reduced qwen2,
float32): over the (2, 2) mesh they are equal bit for bit; over (4, 1)
and with ``accum_steps=2`` the clip's global norm sums a leaf's squares
block by block, in another order than the whole leaf's, so the metrics
are held within 1e-6 relative and the state within 1e-6 of each leaf's
largest magnitude.  Compression, which precedes the clip, is equal bit
for bit over blocks (int8's scale is the max over the blocks; top-k keeps
the leaf's k largest).  Checkpoints cross between blocked storage and
the reference's ``CheckpointManager`` bit for bit; an elastic shrink keeps
every value and the single device's loss within 1e-5; an injected NaN
rolls back to the same blocks.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import test_distributed as ref_dist
import test_torch_data_checkpoint as port_ckpt
import test_torch_dist_train as dist
import test_torch_train as port_train
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.serialization import flatten_with_path
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.data import SyntheticLMPipeline
from repro_torch.distributed import blocked, sharding
from repro_torch.distributed.sharding import param_shardings, shard_params
from repro_torch.models import Model
from repro_torch.optim import adamw, clip_by_global_norm, global_norm
from repro_torch.optim.compress import compressed_gradients, ef_init
from repro_torch.runtime.elastic import ElasticController
from repro_torch.runtime.fault import FaultTolerantTrainer
from repro_torch.runtime.train_loop import (
    TrainState,
    build_train_step,
    init_train_state,
    sharded_value_and_grad,
)

CHUNK, LR = port_train.CHUNK, port_train.LR
#: the configs whose layouts are held: dense, MoE, SSM, hybrid
LAYOUT_CONFIGS = ("qwen2-1.5b", "qwen3-moe-235b-a22b", "mamba2-2.7b",
                  "zamba2-7b")
MESHES = {("data", "model"): (2, 4), ("pod", "data", "model"): (2, 2, 2)}

REF_BODY = """
    import json
    import jax, jax.numpy as jnp
    from repro.configs import get_config, reduced
    from repro.distributed.mesh import plan_from_mesh
    from repro.distributed.sharding import param_shardings
    from repro.models.model import init_params
    from repro.optim import adamw

    out = {}
    for shape, names in MESHES:
        m = jax.make_mesh(shape, names)
        pl = plan_from_mesh(m)
        got = out[str(names)] = {}
        for arch in ARCHS:
            cfg = reduced(get_config(arch), d_model=128)
            shapes = jax.eval_shape(lambda: init_params(
                cfg, jax.random.PRNGKey(0)))
            opt = jax.eval_shape(adamw(1e-3).init, shapes)
            tree = {"params": shapes, "opt_state": opt}
            sh = {"params": param_shardings(cfg, pl, shapes),
                  "opt_state": param_shardings(cfg, pl, opt)}
            leaves = {}
            for (path, leaf), s in zip(
                    jax.tree_util.tree_flatten_with_path(tree)[0],
                    jax.tree_util.tree_leaves(sh)):
                # the shards a placed array is cut into, by device
                where = s.devices_indices_map(leaf.shape)
                blocks = {}
                for i, dev in enumerate(m.devices.flat):
                    idx = [[sl.start or 0, n if sl.stop is None else sl.stop]
                           for sl, n in zip(where[dev], leaf.shape)]
                    blocks.setdefault(json.dumps(idx), [
                        idx, [b - a for a, b in idx], i])
                leaves[jax.tree_util.keystr(path)] = sorted(blocks.values())
            got[arch] = leaves
    print("REF_JSON " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_layout():
    body = REF_BODY.replace("ARCHS", repr(LAYOUT_CONFIGS)).replace(
        "MESHES", repr([(v, k) for k, v in MESHES.items()]))
    stdout = ref_dist.run_in_subprocess(body)
    line = next(x for x in stdout.splitlines() if x.startswith("REF_JSON "))
    return json.loads(line[len("REF_JSON "):])


def port_layout(x):
    """A stored leaf's blocks as the reference's: [[start, stop] per dim],
    the block's shape, the flat mesh index of the position storing it."""
    if not blocked.is_blocked(x):
        return [[[[0, n] for n in x.shape], list(x.shape), 0]]
    out = []
    for (region, owner), b in zip(x.sharding.blocks(x.shape), x.blocks):
        assert list(b.shape) == [n for _, n in region]
        out.append([[[s, s + n] for s, n in region], list(b.shape), owner])
    return sorted(out)


@pytest.mark.parametrize("names", list(MESHES), ids=str)
def test_stored_blocks_are_the_reference_addressable_shards(ref_layout,
                                                            names):
    plan = dist.plan(MESHES[names], names)
    for arch in LAYOUT_CONFIGS:
        cfg = reduced(get_config(arch), d_model=128)
        state = init_train_state(Model(cfg, plan=plan), adamw(1e-3),
                                 torch.Generator().manual_seed(0))
        got = {path: port_layout(x) for path, x in flatten_with_path(
            {"params": state.params, "opt_state": state.opt_state})}
        want = ref_layout[str(names)][arch]
        assert got == want, arch


def test_blocks_tile_each_leaf_and_split_the_bytes():
    """Each leaf's distinct blocks tile it: their bytes sum to the whole
    tree's, no stored tensor is larger than its block (none is a view of a
    larger tensor), and a leaf the spec splits is never whole.  The
    gradient accumulator of a step is laid out as the parameters."""
    cfg = dataclasses.replace(reduced(get_config("qwen2-1.5b"), d_model=128),
                              dtype="float32")
    plan = dist.plan((2, 4))
    whole = Model(cfg).init(torch.Generator().manual_seed(0))
    params = shard_params(cfg, plan, whole)
    sh = blocked.leaves(param_shardings(cfg, plan, whole))
    for x, w, s in zip(blocked.leaves(params), pytree.tree_leaves(whole), sh):
        split = len(s.blocks(w.shape)) > 1
        assert blocked.is_blocked(x) == split
        stored = x.blocks if split else [x]
        assert sum(b.numel() for b in stored) == w.numel()
        for b in stored:
            assert b.untyped_storage().nbytes() == b.numel() * b.element_size()
        assert torch.equal(blocked.whole(x), w)
    total = sum(x.numel() * x.element_size()
                for x in pytree.tree_leaves(whole))
    assert sum(blocked.stored_bytes(params).values()) == total
    model = Model(cfg, plan=plan, attn_chunk=CHUNK, loss_chunk=CHUNK)
    _, _, grads = sharded_value_and_grad(
        model, params, port_train.make_batch(cfg, 1, b=4)[1])
    for g, p in zip(blocked.leaves(grads), blocked.leaves(params)):
        assert blocked.is_blocked(g) == blocked.is_blocked(p)
        if blocked.is_blocked(g):
            assert g.sharding == p.sharding
            assert [b.shape for b in g.blocks] == [b.shape for b in p.blocks]


def test_each_layer_is_gathered_inside_its_remat():
    """The backward's recompute gathers each layer again (the gathered
    copies are not kept from the forward): the backward takes as many
    parts through ``position_params`` as the forward took (the layers';
    qwen2's head is tied, gathered whole like the embedding and the final
    norm, once, outside any remat)."""
    cfg = dataclasses.replace(reduced(get_config("qwen2-1.5b")),
                              dtype="float32")
    plan = dist.plan((2, 2))
    params = shard_params(cfg, plan, Model(cfg).init(
        torch.Generator().manual_seed(0)))
    model = Model(cfg, plan=plan, attn_chunk=CHUNK, loss_chunk=CHUNK)
    batch = port_train.make_batch(cfg, 2, b=4)[1]
    flat, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in flat]
    calls = []
    take = sharding.take

    def counting(x, device, dim=None, ranges=()):
        calls.append(torch.is_grad_enabled())
        return take(x, device, dim, ranges)
    sharding.take = counting
    try:
        loss = model.position_loss(pytree.tree_unflatten(leaves, spec),
                                   batch, 0)[0]
        forward = len(calls)
        torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        sharding.take = take
    assert cfg.tie_embeddings
    assert forward and len(calls) == 2 * forward


def steps(model, state, cfg, n=3, accum=1, compress=None):
    step = build_train_step(model, adamw(LR), accum_steps=accum,
                            clip_norm=1.0, compress=compress)
    mets = []
    for i in range(n):
        state, met = step(state, port_train.make_batch(cfg, 10 + i, b=4)[1])
        mets.append({k: float(v) for k, v in met.items()})
    return mets, state


def gathered(tree):
    return blocked.map_leaves(
        lambda x: x if x is None else blocked.whole(x), tree)


@pytest.fixture(scope="module")
def small():
    _, cfg = port_train.configs("qwen2-1.5b")
    return cfg, Model(cfg).init(torch.Generator().manual_seed(0))


def both_states(cfg, plan, params, compress=None):
    """The whole-storage state and the blocked one, from one weights."""
    opt = adamw(LR)
    out = []
    for p in (params, shard_params(cfg, plan, params)):
        out.append(TrainState(params=p, opt_state=opt.init(p),
                              ef=ef_init(p) if compress else None,
                              step=torch.zeros((), dtype=torch.int32)))
    return out


@pytest.mark.parametrize("shape,accum,exact", [
    ((2, 2), 1, True), ((2, 2), 2, False), ((4, 1), 1, False)], ids=str)
def test_steps_over_blocks_equal_whole_storage(small, shape, accum, exact):
    cfg, params = small
    plan = dist.plan(shape)
    model = Model(cfg, plan=plan, attn_chunk=CHUNK, loss_chunk=CHUNK)
    (wm, ws), (gm, gs) = (steps(model, st, cfg, accum=accum)
                          for st in both_states(cfg, plan, params))
    assert blocked.is_blocked(gs.opt_state["mu"]["embed"])
    want, got = port_train.by_path(ws), port_train.by_path(gathered(gs))
    assert set(got) == set(want)
    for w, g in zip(wm, gm):
        for k in w:
            if exact:
                assert g[k] == w[k], k
            else:
                assert g[k] == pytest.approx(w[k], rel=1e-6, abs=1e-9), k
    for path, w in want.items():
        tol = 0 if exact else 1e-6 * (np.abs(w).max() + 1e-12)
        np.testing.assert_allclose(got[path], w, rtol=0, atol=tol,
                                   err_msg=path)


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_compression_over_blocks_equals_whole_storage(small, method):
    """Compression runs per leaf over its blocks: the reconstruction and the
    residual are the whole leaf's, bit for bit."""
    cfg, params = small
    plan = dist.plan((2, 2))
    p = shard_params(cfg, plan, params)
    rng = np.random.default_rng(0)
    grads = pytree.tree_map(lambda x: torch.from_numpy(
        rng.standard_normal(x.shape).astype(np.float32)), params)
    ef = ef_init(params)
    ef = ef._replace(residual=pytree.tree_map(lambda x: x + 1e-3, grads))
    want = compressed_gradients(grads, ef, method=method)
    got = compressed_gradients(
        shard_params(cfg, plan, grads), ef._replace(residual=shard_params(
            cfg, plan, ef.residual)), method=method)
    assert blocked.is_blocked(got[0]["embed"])
    for a, b in zip(pytree.tree_leaves(want),
                    blocked.leaves(gathered(got))):
        assert torch.equal(a, blocked.whole(b))
    assert p["embed"].sharding == got[0]["embed"].sharding


def test_clip_norm_over_blocks_is_one_devices(small):
    cfg, params = small
    plan = dist.plan((2, 4))
    rng = np.random.default_rng(1)
    grads = pytree.tree_map(lambda x: torch.from_numpy(
        rng.standard_normal(x.shape).astype(np.float32)), params)
    want_t, want_n = clip_by_global_norm(grads, 1.0)
    got_t, got_n = clip_by_global_norm(shard_params(cfg, plan, grads), 1.0)
    assert float(global_norm(shard_params(cfg, plan, grads))) == float(got_n)
    assert float(got_n) == pytest.approx(float(want_n), rel=1e-6)
    for a, b in zip(pytree.tree_leaves(want_t), blocked.leaves(got_t)):
        torch.testing.assert_close(blocked.whole(b), a, rtol=2e-6, atol=0)


def test_checkpoints_cross_between_blocks_and_the_reference(small,
                                                            tmp_path):
    """A blocked state saved by the port is restored whole by the
    reference's ``CheckpointManager``, bit for bit, and the reference's
    checkpoint of the whole state is restored into the blocks' layout."""
    cfg, params = small
    plan = dist.plan((2, 2))
    whole, state = both_states(cfg, plan, params, compress="int8")
    state = steps(Model(cfg, plan=plan, attn_chunk=CHUNK, loss_chunk=CHUNK),
                  state, cfg, n=1, compress="int8")[1]
    flat = gathered(state)
    CheckpointManager(tmp_path / "a").save(1, state)
    jtree = port_ckpt.jax_tree(flat)
    port_ckpt.assert_bits_equal(
        flat, JaxCheckpointManager(tmp_path / "a").restore(jtree))
    JaxCheckpointManager(tmp_path / "b").save(1, jtree)
    back = CheckpointManager(tmp_path / "b").restore(state)
    for a, b in zip(blocked.leaves(back), blocked.leaves(state)):
        assert blocked.is_blocked(a) == blocked.is_blocked(b)
        if blocked.is_blocked(a):
            assert a.sharding == b.sharding
            assert all(torch.equal(x, y) for x, y in zip(a.blocks, b.blocks))
        else:
            assert torch.equal(a, b)


def test_elastic_shrink_from_four_positions_to_two(small):
    cfg, params = small
    ctl = ElasticController(cfg, prefer_model=2)
    p4, plan4 = ctl.remesh(shard_params(cfg, dist.plan((2, 2)), params),
                           ["cpu"] * 4)
    p2, plan2 = ctl.remesh(p4, ["cpu"] * 2)
    assert plan2.mesh.shape == {"data": 1, "model": 2}
    assert ctl.events == [(4, (2, 2)), (2, (1, 2))]
    for a, b in zip(pytree.tree_leaves(params), blocked.leaves(p2)):
        assert torch.equal(a, blocked.whole(b))
    assert p2["layers"]["mlp"]["wu"].sharding.mesh is plan2.mesh
    batch = port_train.make_batch(cfg, 11, b=4)[1]
    want, _ = Model(cfg, attn_chunk=CHUNK, loss_chunk=CHUNK).loss(params,
                                                                  batch)
    for p, pl in ((p4, plan4), (p2, plan2)):
        loss, _ = Model(cfg, plan=pl, attn_chunk=CHUNK,
                        loss_chunk=CHUNK).loss(p, batch)
        assert float(loss) == pytest.approx(float(want), rel=1e-5)


def test_an_injected_nan_rolls_back_to_the_same_blocks(small):
    cfg, _ = small
    plan = dist.plan((2, 2))
    model = Model(cfg, plan=plan, attn_chunk=CHUNK, loss_chunk=CHUNK)
    opt = adamw(LR)
    state = init_train_state(model, opt, torch.Generator().manual_seed(0))
    tr = FaultTolerantTrainer(
        step_fn=build_train_step(model, opt, clip_norm=1.0), state=state,
        data=SyntheticLMPipeline(cfg, batch=4, seq=16, seed=3, device="cpu"),
        corrupt_loss_at=1)
    tr.run(1)
    before = tr.committed_state
    saved = [(x, x.clone(), x._version) for x in pytree.tree_leaves(before)
             if x is not None]
    tr.run(1)
    assert tr.rollbacks == 1 and tr.committed_state is before
    for x, copy, version in saved:
        assert x._version == version and torch.equal(x, copy)
    tr.run(1)
    assert len(tr.metrics_log) == 2
    assert blocked.is_blocked(tr.state.params["embed"])


def test_zero1_moments_keep_their_layout_over_a_step(small):
    """On a (pod 2, data 2, model 1) mesh the moments are split over
    ``("pod", "data")`` where the parameters are over ``data`` (the JAX
    package's placement of AdamW's state): a step runs each leaf in the
    parameter's layout and stores the moments back in their own, equal
    to one device's."""
    cfg, params = small
    plan = dist.plan((2, 2, 1), ("pod", "data", "model"))
    model = Model(cfg, plan=plan, attn_chunk=CHUNK, loss_chunk=CHUNK)
    opt = adamw(LR)
    state = init_train_state(model, opt, torch.Generator().manual_seed(0))
    assert state.params["embed"].sharding.spec == (None, "data")
    assert state.opt_state["mu"]["embed"].sharding.spec == (
        None, ("pod", "data"))
    one = Model(cfg, attn_chunk=CHUNK, loss_chunk=CHUNK)
    (wm, ws), (gm, gs) = (steps(m, init_train_state(
        m, opt, torch.Generator().manual_seed(0)), cfg, n=1)
        for m in (one, model))
    assert gs.opt_state["mu"]["embed"].sharding == \
        state.opt_state["mu"]["embed"].sharding
    assert gm[0]["loss"] == pytest.approx(wm[0]["loss"], rel=1e-6)
    for a, b in zip(blocked.leaves(gs.opt_state), blocked.leaves(
            ws.opt_state)):
        torch.testing.assert_close(blocked.whole(a), b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
