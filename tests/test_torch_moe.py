"""Port parity: the MoE family (``qwen3-moe-235b-a22b``, ``dbrx-132b``).

``moe_apply_local`` of ``repro_torch.models.moe`` against the JAX
package's on the same numpy inputs, for the three activations, with a
router skewed towards one expert so that assignments overflow the
capacity and are dropped (the test asserts that some are), and with tied
router columns (the lower expert id wins, as ``lax.top_k``).  Then
``Model`` prefill and decode, and the paged ``ServeEngine`` against the
JAX engine (greedy tokens, counters and ``spec_verify`` rows on the fused,
``"ref"`` and int8 paths), for both configs at ``reduced()`` widths in
float32, from one set of weights: the reference's ``Model.init(PRNGKey(0))``
through numpy into ``params_from_jax``.  Tolerance 1e-4: float32 on both
sides, with summation orders that differ between XLA and PyTorch.
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
from repro.models import moe as jax_moe
from repro.models.model import Model as JaxModel
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import reduced as port_reduced
from repro_torch.models import Model
from repro_torch.models import moe as port_moe
from repro_torch.runtime import ServeEngine

TOL = 1e-4
NAMES = ["qwen3-moe-235b-a22b", "dbrx-132b"]
#: total and active ArchConfig.param_count() in billions, and KV bytes per
#: token (bf16, KiB), of the full configs
SIZES = {"qwen3-moe-235b-a22b": (235.09, 22.19, 188),
         "dbrx-132b": (131.6, 36.47, 160)}
PROMPT = (5, 17, 3, 42, 7, 11, 2, 9, 30, 4, 8, 1, 22)


def configs(name, **kw):
    """The reduced configuration from both packages, at float32."""
    kw = {"dtype": "float32", **kw}
    return (dataclasses.replace(reduced(get_config(name)), **kw),
            dataclasses.replace(port_reduced(port_config(name)), **kw))


@functools.lru_cache(maxsize=None)
def reference(name):
    """The JAX model of ``name`` at float32 and its weights (jax, numpy)."""
    jcfg, _ = configs(name)
    jmodel = JaxModel(jcfg, attn_chunk=8, remat=False)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    return jmodel, jparams, jax.tree_util.tree_map(np.asarray, jparams)


def shapes(tree):
    return {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)
                                      .replace("torch.", ""))
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", NAMES)
def test_config_copy_and_sizes(name):
    full = port_config(name)
    assert dataclasses.asdict(full) == dataclasses.asdict(get_config(name))
    assert full.param_count() == get_config(name).param_count()
    assert full.active_param_count() == get_config(name).active_param_count()
    total, active, kib = SIZES[name]
    assert round(full.param_count() / 1e9, 2) == total
    assert round(full.active_param_count() / 1e9, 2) == active
    assert full.kv_bytes_per_token() == kib * 1024
    assert dataclasses.asdict(port_reduced(full)) == \
        dataclasses.asdict(reduced(get_config(name)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_port_init_has_the_reference_layout(name, dtype):
    """Shapes and dtypes leaf by leaf; the router stays f32 in a bf16
    model."""
    jcfg, pcfg = configs(name, dtype=dtype)
    jparams = jax.eval_shape(JaxModel(jcfg).init, jax.random.PRNGKey(0))
    pparams = Model(pcfg).init(torch.Generator().manual_seed(0))
    assert shapes(pparams) == shapes(jparams)
    assert pparams["layers"]["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("name", NAMES)
def test_bridge_takes_the_reference_tree(name):
    _, pcfg = configs(name)
    weights = reference(name)[2]
    pparams = params_from_jax(weights, device="cpu")
    assert shapes(pparams) == shapes(weights)
    assert ("wg" in pparams["layers"]["moe"]) == (
        pcfg.mlp_activation in ("swiglu", "geglu"))


def test_bridge_refuses_a_malformed_moe_subtree():
    weights = jax.tree_util.tree_map(np.copy, reference("dbrx-132b")[2])
    weights["layers"]["moe"]["bias"] = weights["layers"]["moe"]["wu"]
    with pytest.raises(NotImplementedError, match="bias"):
        params_from_jax(weights, device="cpu")
    del weights["layers"]["moe"]["bias"]
    weights["layers"]["mlp"] = weights["layers"]["moe"]
    with pytest.raises(NotImplementedError, match="mlp"):
        params_from_jax(weights, device="cpu")


def moe_inputs(act, router, n=24, d=32, e=4, k=2, f=16):
    """A config and numpy inputs of ``moe_apply_local``; ``router`` skews
    the router towards expert 0 ("skewed") or ties experts 1 and 2
    ("tied")."""
    jcfg = dataclasses.replace(reduced(get_config("dbrx-132b")),
                               mlp_activation=act, num_experts=e,
                               experts_per_token=k, d_model=d, d_ff=f,
                               dtype="float32")
    rng = np.random.default_rng(len(act) + len(router))
    x = rng.standard_normal((n, d)).astype(np.float32)
    rw = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    if router == "skewed":
        x[:, 0] = np.abs(x[:, 0]) + 1.0
        rw[0, 0] = 4.0           # expert 0 in nearly every token's top K
    else:
        rw[:, 2] = rw[:, 1]      # equal probabilities for experts 1 and 2
    w = {"wu": (e, d, f), "wg": (e, d, f), "wd": (e, f, d)}
    ws = {name: (rng.standard_normal(shape) / np.sqrt(shape[1]))
          .astype(np.float32) for name, shape in w.items()}
    if act == "sqrelu":
        ws["wg"] = None
    return jcfg, x, rw, ws


@pytest.mark.parametrize("router", ["skewed", "tied"])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "sqrelu"])
def test_moe_apply_local_matches_jax_with_drops(act, router):
    jcfg, x, rw, ws = moe_inputs(act, router)
    pcfg = port_config("dbrx-132b").__class__(**dataclasses.asdict(jcfg))
    jy, jaux = jax_moe.moe_apply_local(
        jcfg, jnp.asarray(x), jnp.asarray(rw),
        None if ws["wg"] is None else jnp.asarray(ws["wg"]),
        jnp.asarray(ws["wu"]), jnp.asarray(ws["wd"]), jnp.int32(0))
    t = {k: None if v is None else torch.from_numpy(v) for k, v in ws.items()}
    py, paux = port_moe.moe_apply_local(pcfg, torch.from_numpy(x),
                                        torch.from_numpy(rw), t["wg"],
                                        t["wu"], t["wd"])
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(paux.item(), float(jaux), rtol=TOL, atol=TOL)
    # the routing overflowed: some assignments were dropped
    probs = torch.softmax(torch.from_numpy(x @ rw), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :2]
    cap = port_moe._capacity(x.shape[0], pcfg)
    assert cap == jax_moe._capacity(x.shape[0], jcfg)
    if router == "skewed":
        assert torch.bincount(top.reshape(-1), minlength=4).max() > cap
    else:   # a tie goes to the lower expert id
        tied = probs[:, 1] == probs[:, 2]
        assert tied.all()
        assert not ((top == 2).any(-1) & ~(top == 1).any(-1)).any()


def test_moe_block_refuses_a_mesh():
    """The mesh refusal is gone: over a 2-way tp mesh the expert-parallel
    branch runs and gives the single device's output within 1e-4
    (``tests/test_torch_tp_moe.py`` holds it with drops and ties against
    the reference); a mesh without a tp axis keeps the single-device path,
    as the reference's ``moe_block`` does."""
    from repro_torch.distributed import serving_mesh

    cfg = dataclasses.replace(port_reduced(port_config("dbrx-132b")),
                              dtype="float32")
    p = port_moe.init_moe(cfg, torch.Generator().manual_seed(0),
                          torch.float32)
    x = torch.randn(1, 6, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    y, aux = port_moe.moe_block(cfg, p, x)
    mesh = serving_mesh(2, ["cpu"] * 2)
    assert torch.equal(port_moe.moe_block(cfg, p, x, mesh=mesh)[0], y)
    y_ep, aux_ep = port_moe.moe_block(cfg, p, x, mesh=mesh, tp_axis="tp")
    torch.testing.assert_close(y_ep, y, atol=TOL, rtol=TOL)
    torch.testing.assert_close(aux_ep, aux, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", NAMES)
def test_decode_state_specs_match_the_reference(name):
    jcfg, pcfg = configs(name)
    jstate = JaxModel(jcfg).init_decode_state(3, 10)
    pstate = Model(pcfg).init_decode_state(3, 10, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in pstate.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in jstate.items()}


@pytest.mark.parametrize("pos_form", ["vector", "scalar"])
@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_jax(name, pos_form):
    """Prefill of a 2 x 9 prompt (18 tokens routed together), then four
    decode steps: logits every step, and the caches after the last."""
    jcfg, pcfg = configs(name)
    jmodel, jparams, weights = reference(name)
    pparams = params_from_jax(weights, device="cpu")
    pmodel = Model(pcfg)
    rng = np.random.default_rng(len(name))
    b, s, steps = 2, 9, 4
    tokens = rng.integers(0, jcfg.vocab_size, (b, s))
    jl, jc = jmodel.prefill(jparams, jnp.asarray(tokens), max_len=s + steps)
    pl, pc = pmodel.prefill(pparams, torch.from_numpy(tokens),
                            max_len=s + steps)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
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
    assert set(pc) == set(jc) == {"k", "v"}
    for n in jc:
        np.testing.assert_allclose(pc[n].numpy(), np.asarray(jc[n]),
                                   rtol=TOL, atol=TOL)


def engines(name, *, legacy=False, **kw):
    jcfg, pcfg = configs(name)
    jmodel, jparams, weights = reference(name)
    kw.update(num_pages=128, page_size=4, max_pages_per_seq=16)
    return (jax_serve.ServeEngine(
                jmodel, jparams, attn_impl="ref" if legacy else "fused_ref",
                **kw),
            ServeEngine(Model(pcfg), params_from_jax(weights, device="cpu"),
                        device="cpu", attn_impl="ref" if legacy else "auto",
                        **kw))


def exercise(eng):
    """Decode, a lazy-CoW fork of the partial tail page, three batched
    steps (3 rows routed together), commit, four more steps of the winner,
    release."""
    sid = eng.add_request(list(PROMPT))
    out = eng.decode([sid])
    kids = eng.fork(sid, 3)
    for _ in range(3):
        out += eng.decode(kids)
    eng.commit(kids[1])
    for _ in range(4):
        out += eng.decode([sid])
    eng.release(sid)
    return out


def counters(eng):
    st = eng.stats()
    st.pop("attn_impl")
    return st


@pytest.mark.parametrize("path", ["fused", "ref", "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_engine_greedy_tokens_and_counters_identical(name, path):
    kw = {"kv_dtype": "int8"} if path == "int8" else {}
    jeng, peng = engines(name, legacy=path == "ref", **kw)
    assert exercise(peng) == exercise(jeng)
    assert peng.cow_faults == jeng.cow_faults > 0
    assert counters(peng) == counters(jeng)
    assert peng.stats()["pages_free"] == peng.stats()["pages_total"]


@pytest.mark.parametrize("name", NAMES)
def test_engine_spec_verify_rows_identical(name):
    """Three drafts of four tokens: 12 rows routed in one pass."""
    jeng, peng = engines(name)
    rows = {}
    for label, eng in (("jax", jeng), ("port", peng)):
        sid = eng.add_request([9, 8, 7, 6, 5])
        eng.decode([sid])
        (branch,) = eng.fork(sid, 1)
        greedy = [eng.decode([branch])[0] for _ in range(4)]
        rows[label] = eng.spec_verify(sid, [greedy, [greedy[0], 0, 1, 2],
                                            [0, 1, 2, 3]])
        assert eng.verify_dispatches == 1
        assert rows[label][0] == greedy
    assert rows["port"] == rows["jax"]


def test_serve_cli_serves_dbrx_on_the_cpu(capsys):
    """``--arch dbrx-132b --device cpu`` runs the reduced config at
    float32 (the JAX demo's rule above 1e8 parameters): best-of-2 commits
    its winner and every handle is closed."""
    from repro_torch.launch import serve as port_cli

    assert port_cli.main(["--arch", "dbrx-132b", "--device", "cpu",
                          "--tokens", "2", "--requests", "1",
                          "--branches", "2"]) == 0
    out = capsys.readouterr().out
    assert "request 0" in out and "(best of 2, scores" in out
    assert "handles: 0 open" in out
