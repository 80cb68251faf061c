"""Port parity: prefill and decode over a (pod, data, model) plan, and the
uneven head split (an attention block whose heads do not split over the
model axis runs whole on every model position).

``Model(plan=).prefill`` and ``decode_step`` (``models/plan_decode.py``)
over meshes of the CPU named several times, ``(2, 2)``, ``(1, 4)`` and
``(2, 2, 2)``, are held against the reference's *single-device*
``Model.prefill``/``decode_step`` (its own sharded steps fail on the
installed JAX, ``tests/test_distributed.py``), one family at a time at
``reduced()`` widths in float32: the dense family at 6 heads over 2 kv
heads (whose heads do not split over 4 model positions), the MoE family
(8 experts, top 2, capacity factor 8: no drops, so each data position's
own routing is the single device's), mamba2, zamba2, musicgen (four
codebooks) and pixtral (``frontend_embed``).  Weights come from the port's
seeded init, handed to the reference as jnp arrays.  The last logits, the
cache gathered from its blocks and four greedy decode steps' logits agree
within ``tests/test_torch_tp.py``'s ``TOL`` (float32 on both sides, other
summation orders: the sums over model positions, the sequence-parallel
decode attention's merged partial softmax); the greedy tokens are
identical.

The uneven split: at 6 heads over 2 kv heads and model 4, the loss and
the first-step gradients over ``(1, 4)`` and ``(2, 4)`` meshes are within
1e-5 of the port's single device (relative; gradients against each leaf's
largest magnitude), the loss within 1e-5 of the reference's single device,
and the tensor-parallel engine at tp 4 is token-identical to tp 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_config
from repro.configs.base import reduced
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import reduced as port_reduced
from repro_torch.distributed import blocked
from repro_torch.distributed.mesh import DeviceMesh, plan_from_mesh
from repro_torch.distributed.sharding import heads_split, rank_ranges
from repro_torch.models import Model
from repro_torch.runtime import ServeEngine
from repro_torch.runtime.train_loop import value_and_grad

TOL = 1e-4
B, S, MAX_LEN, STEPS = 4, 12, 20, 4
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
#: the family configs: (registered name, field changes)
FAMILIES = {
    "dense": ("qwen2-1.5b", dict(num_heads=6, num_kv_heads=2, head_dim=16,
                                 d_model=96, d_ff=192)),
    "moe": ("qwen3-moe-235b-a22b", dict(num_experts=8, experts_per_token=2,
                                        moe_capacity_factor=8.0)),
    "mamba2": ("mamba2-2.7b", {}),
    "zamba2": ("zamba2-7b", {}),
    "musicgen": ("musicgen-medium", {}),
    "pixtral": ("pixtral-12b", {}),
}


def configs(family):
    name, kw = FAMILIES[family]
    kw = {"dtype": "float32", **kw}
    return (dataclasses.replace(reduced(get_config(name)), **kw),
            dataclasses.replace(port_reduced(port_config(name)), **kw))


def plan(mesh):
    shape, names = MESHES[mesh]
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = ["cpu"] * devs.size
    return plan_from_mesh(DeviceMesh(devs.reshape(shape), names))


def to_jax(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tree)


def np_of(x):
    return np.asarray(x, dtype=np.float32)


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """The family's weights, inputs and the reference's single-device
    prefill and greedy decode."""
    jcfg, cfg = configs(request.param)
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    shape = (B, S, cfg.num_codebooks) if cfg.num_codebooks > 1 else (B, S)
    tokens = rng.integers(0, cfg.vocab_size, shape)
    fe = None
    if cfg.frontend == "vlm_stub":
        fe = rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model)
                                 ).astype(np.float32)
    jm = JaxModel(jcfg, attn_chunk=8, remat=False)
    jparams = to_jax(params)
    prefill = jax.jit(lambda p, t, f: jm.prefill(p, t, f, max_len=MAX_LEN))
    decode = jax.jit(jm.decode_step)
    logits, cache = prefill(jparams, jnp.asarray(tokens, jnp.int32),
                            None if fe is None else jnp.asarray(fe))
    ref = {"prefill": np_of(logits),
           "cache": {k: np_of(v) for k, v in cache.items()}, "steps": []}
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    for t in range(STEPS):
        pos = jnp.full((B,), S + t, jnp.int32)
        logits, cache = decode(jparams, cache, tok, pos)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        ref["steps"].append((np_of(logits), np.asarray(tok)))
    ref["final_cache"] = {k: np_of(v) for k, v in cache.items()}
    return cfg, params, tokens, fe, ref


def close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL, f"{what}: max |diff| {err:.3g} > {TOL}"


@pytest.mark.parametrize("mesh", list(MESHES))
def test_plan_prefill_and_decode_match_the_reference(family, mesh):
    cfg, params, tokens, fe, ref = family
    model = Model(cfg, plan=plan(mesh), attn_chunk=8)
    logits, cache = model.prefill(
        params, torch.from_numpy(tokens).long(),
        None if fe is None else torch.from_numpy(fe), max_len=MAX_LEN)
    close(logits, ref["prefill"], "prefill logits")
    assert set(cache) == set(ref["cache"])
    for k, want in ref["cache"].items():
        assert blocked.is_blocked(cache[k]) or cache[k].shape == want.shape
        close(blocked.whole(cache[k], "cpu"), want, f"prefill cache {k}")
    tok = logits.argmax(-1)
    for t, (want, want_tok) in enumerate(ref["steps"]):
        pos = torch.full((B,), S + t, dtype=torch.long)
        logits, cache = model.decode_step(params, cache, tok, pos)
        close(logits, want, f"decode step {t} logits")
        tok = logits.argmax(-1)
        np.testing.assert_array_equal(tok.numpy(), want_tok)
    for k, want in ref["final_cache"].items():
        close(blocked.whole(cache[k], "cpu"), want, f"final cache {k}")


# ---------------------------------------------------------------------------
# the uneven head split
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def uneven():
    jcfg, cfg = configs("dense")
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (4, 16))
    batch = {"tokens": torch.from_numpy(tokens).long(),
             "targets": torch.from_numpy(np.roll(tokens, -1, 1)).long()}
    jm = JaxModel(jcfg, attn_chunk=8, loss_chunk=8, remat=False)
    jloss = float(jax.jit(jm.loss)(
        to_jax(params), {k: jnp.asarray(v.numpy(), jnp.int32)
                         for k, v in batch.items()})[0])
    one = value_and_grad(Model(cfg, attn_chunk=8, loss_chunk=8), params,
                         batch)
    return cfg, params, batch, jloss, one


def test_six_heads_over_two_kv_heads_do_not_split_over_four():
    _, cfg = configs("dense")
    assert not heads_split(cfg, 4)
    assert heads_split(cfg, 2) and heads_split(cfg, 6)
    assert not heads_split(cfg, 3)      # rank 1: heads [2, 4), two groups
    # the attention leaves whole at 4, split by head at 2
    assert rank_ranges(cfg, ("attn", "wk"), (96, 2, 16), 1, 4) \
        == (None, [])
    assert rank_ranges(cfg, ("attn", "wq"), (96, 6, 16), 1, 2) \
        == (1, [(3, 3)])
    # the MLP keeps its split
    assert rank_ranges(cfg, ("mlp", "wu"), (96, 192), 1, 4) \
        == (1, [(48, 48)])


@pytest.mark.parametrize("shape", [(1, 4), (2, 4)], ids=["1x4", "2x4"])
def test_uneven_heads_train_as_one_device(uneven, shape):
    cfg, params, batch, jloss, (loss1, _, grads1) = uneven
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = ["cpu"] * devs.size
    model = Model(cfg, plan=plan_from_mesh(DeviceMesh(
        devs.reshape(shape), ("data", "model"))), attn_chunk=8, loss_chunk=8)
    from repro_torch.runtime.train_loop import sharded_value_and_grad
    loss, _, grads = sharded_value_and_grad(model, params, batch)
    assert abs(float(loss) - float(loss1)) <= 1e-5 * abs(float(loss1))
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)
    for g, g1 in zip(pytree.tree_leaves(grads), pytree.tree_leaves(grads1)):
        scale = float(g1.abs().max()) or 1.0
        assert float((g - g1).abs().max()) <= 1e-5 * scale


def test_uneven_heads_serve_at_tp4_as_tp1(uneven):
    cfg, params, _, _, _ = uneven
    geometry = dict(num_pages=64, page_size=4, max_pages_per_seq=16)
    runs = []
    for tp in (None, 4):
        eng = ServeEngine(Model(cfg), params, device="cpu", tp=tp,
                          **geometry)
        seq = eng.add_request(list(range(1, 10)))
        kids = eng.fork(seq, 2)
        out = [eng.decode(kids, greedy=True) for _ in range(4)]
        runs.append((out, eng.kv_tp, len(eng.shards)))
    assert runs[0][0] == runs[1][0]
    assert runs[1][1:] == (1, 4)      # every shard holds every kv head
