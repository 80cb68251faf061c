"""Port parity: the expert-parallel MoE (``moe_block`` over a mesh, and the
MoE engine at ``tp=2``) on the CPU.

``moe_block`` with a 2-way tp mesh (every shard on the CPU) against the
JAX package's single-device ``moe_block`` and the port's own, on the same
numpy inputs: a router skewed towards one expert, so that assignments
overflow the capacity and are dropped, and tied router columns (the lower
expert id wins, as ``lax.top_k``).  The reference's own EP test compares
its ``shard_map`` branch with its single device; the port's branch is
held to the same claim.  Then the MoE engine at tp 2 against the
reference's single-device engine (``tests/test_distributed.py::
test_tp_moe_serving_matches_single_device``: an eager-CoW fan-out) on the
fused, ``"ref"`` and int8 paths, with the expert ids of every routing call
equal to one shard's.  Tolerance 1e-4: float32 on both sides, the shards'
outputs summed in another order than one combine does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime.serve_loop as jax_serve
from repro.configs import get_config
from repro.configs.base import reduced
from repro.models import moe as jax_moe
from repro.models.model import Model as JaxModel
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import reduced as port_reduced
from repro_torch.distributed import DeviceMesh, serving_mesh
from repro_torch.models import Model
from repro_torch.models import moe as port_moe
from repro_torch.runtime import ServeEngine

TOL = 1e-4


def moe_case(act, router, n=24, d=32, e=4, k=2, f=16):
    """A config (both packages) and numpy inputs of the MoE block;
    ``router`` skews the router towards expert 0 ("skewed") or ties
    experts 1 and 2 ("tied")."""
    kw = dict(mlp_activation=act, num_experts=e, experts_per_token=k,
              d_model=d, d_ff=f, dtype="float32")
    jcfg = dataclasses.replace(reduced(get_config("dbrx-132b")), **kw)
    pcfg = dataclasses.replace(port_reduced(port_config("dbrx-132b")), **kw)
    rng = np.random.default_rng(len(act) + len(router))
    x = rng.standard_normal((2, n // 2, d)).astype(np.float32)
    rw = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    if router == "skewed":
        x[..., 0] = np.abs(x[..., 0]) + 1.0
        rw[0, 0] = 4.0           # expert 0 in nearly every token's top K
    else:
        rw[:, 2] = rw[:, 1]      # equal probabilities for experts 1 and 2
    p = {"router": rw}
    for name, shape in (("wu", (e, d, f)), ("wg", (e, d, f)),
                        ("wd", (e, f, d))):
        if name == "wg" and act == "sqrelu":
            continue
        p[name] = (rng.standard_normal(shape) / np.sqrt(shape[1])).astype(
            np.float32)
    return jcfg, pcfg, x, p


@pytest.mark.parametrize("router", ["skewed", "tied"])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "sqrelu"])
def test_moe_block_expert_parallel_matches_single_device(act, router):
    """tp 2 (two experts a shard) equals the reference's single device and
    the port's own within 1e-4, aux too; the skewed router drops
    assignments, the tied one routes to the lower id on both."""
    jcfg, pcfg, x, p = moe_case(act, router)
    jy, jaux = jax_moe.moe_block(jcfg, {k: jnp.asarray(v)
                                        for k, v in p.items()},
                                 jnp.asarray(x))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x)
    one_y, one_aux = port_moe.moe_block(pcfg, tp, xt)
    mesh = serving_mesh(2, ["cpu"] * 2)
    y, aux = port_moe.moe_block(pcfg, tp, xt, mesh=mesh, tp_axis="tp")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(y.numpy(), one_y.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL)
    assert float(aux) == pytest.approx(float(one_aux), rel=TOL)
    _, _, ids = port_moe.route(pcfg, xt.reshape(-1, pcfg.d_model),
                               tp["router"])
    counts = torch.bincount(ids.reshape(-1), minlength=pcfg.num_experts)
    cap = port_moe._capacity(ids.shape[0], pcfg)
    if router == "skewed":
        assert int(counts.max()) > cap        # assignments are dropped
    else:
        # 1 and 2 tie: 2 is taken only after 1, never in its place
        rows = [r for r in ids.tolist() if 2 in r]
        assert rows and all(1 in r[:r.index(2)] for r in rows)


def test_moe_block_over_a_model_axis():
    """A 2 x 2 data x model mesh: the experts split over ``model``, the
    batch replicated over ``data``; the single device's result."""
    _, pcfg, x, p = moe_case("swiglu", "skewed")
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x)
    grid = DeviceMesh([["cpu", "cpu"], ["cpu", "cpu"]], ("data", "model"))
    y, _ = port_moe.moe_block(pcfg, tp, xt, mesh=grid, tp_axis="model")
    np.testing.assert_allclose(y.numpy(), port_moe.moe_block(
        pcfg, tp, xt)[0].numpy(), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="experts"):
        port_moe.moe_block(pcfg, tp, xt, mesh=serving_mesh(3, ["cpu"] * 3),
                           tp_axis="tp")


@pytest.fixture(scope="module")
def moe_setup():
    """The reference test's MoE config (4 experts, top 2, kv 2) at float32
    and its weights in both packages."""
    kw = dict(dtype="float32", num_experts=4, experts_per_token=2,
              num_kv_heads=2, moe_capacity_factor=8.0)
    jcfg = dataclasses.replace(
        reduced(get_config("qwen3-moe-235b-a22b"), d_model=64), **kw)
    pcfg = dataclasses.replace(
        port_reduced(port_config("qwen3-moe-235b-a22b"), d_model=64), **kw)
    jmodel = JaxModel(jcfg, attn_chunk=8, remat=False)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    pparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jmodel, jparams, pcfg, pparams


def moe_cycle(eng):
    """Two steps, an eager-CoW fan-out of 3 (one batched copy), a step."""
    sid = eng.add_request([1, 2, 3, 4, 5])
    toks = [eng.decode([sid]) for _ in range(2)]
    kids = eng.fork(sid, 3, eager_cow=True)
    toks.append(eng.decode(kids))
    return toks, eng.cow_dispatches, eng.cow_faults


@pytest.mark.parametrize("capacity", [8.0, 1.0], ids=["no_drops", "drops"])
@pytest.mark.parametrize("path", ["fused", "ref", "int8"])
def test_tp_moe_serving_matches_single_device(moe_setup, monkeypatch, path,
                                              capacity):
    """The MoE engine at tp 2 (2 experts a shard) gives the reference's
    single-device tokens and CoW counters; every routing call's expert ids
    (one per shard and layer) equal one shard's for that layer."""
    jmodel, jparams, pcfg, pparams = moe_setup
    jkw = {"fused": {"attn_impl": "fused_ref"}, "ref": {"attn_impl": "ref"},
           "int8": {"attn_impl": "fused_ref", "kv_dtype": "int8"}}[path]
    pkw = {"fused": {}, "ref": {"attn_impl": "ref"},
           "int8": {"kv_dtype": "int8"}}[path]
    geometry = dict(num_pages=64, page_size=4, max_pages_per_seq=16)
    jmodel = JaxModel(dataclasses.replace(jmodel.cfg,
                                          moe_capacity_factor=capacity),
                      attn_chunk=8, remat=False)
    model = Model(dataclasses.replace(pcfg, moe_capacity_factor=capacity))
    want = moe_cycle(jax_serve.ServeEngine(jmodel, jparams, **jkw,
                                           **geometry))
    calls = []
    route = port_moe.route

    def spy(*args):
        out = route(*args)
        calls.append(out[2].clone())
        return out
    monkeypatch.setattr(port_moe, "route", spy)
    got = {}
    ids = {}
    for tp in (None, 2):
        calls.clear()
        got[tp] = moe_cycle(ServeEngine(model, pparams, device="cpu", tp=tp,
                                        **pkw, **geometry))
        ids[tp] = list(calls)
    assert got[2] == got[None] == want
    assert len(ids[2]) == 2 * len(ids[None]) > 0
    for i, one in enumerate(ids[None]):
        # one dropless shard pads a decode to its rung: its routing call's
        # first rows are the real ones, the rows tp 2 routes
        n = len(ids[2][2 * i])
        assert len(one) >= n
        assert torch.equal(ids[2][2 * i], one[:n])
        assert torch.equal(ids[2][2 * i + 1], one[:n])
