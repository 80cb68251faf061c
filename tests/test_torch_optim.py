"""Port parity: optimizers, schedules, clipping and compression.

Every case of ``tests/test_optim.py`` on the port, then each optimizer,
schedule, clip and compressor of the port against the JAX package's on the
same numpy trees (drawn from a seed).  Tolerances: float32 on both sides;
elementwise arithmetic in the same order, so updates, moments and norms
agree within 1e-6 relative (XLA and PyTorch may round ``pow``, ``sqrt``
and ``cos`` one ulp apart); the int8 codes are identical, since no
element of the data lies within rounding noise of a bucket's midpoint;
top-k data has distinct magnitudes, so the two ``top_k``s pick the same
entries whatever their tie order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import repro.optim as J
from repro.optim.compress import ef_init as jax_ef_init
from repro.optim.compress import topk_decompress as jax_topk_decompress
from repro_torch.checkpoint.serialization import flatten_with_path
from repro_torch.optim import (
    adamw,
    apply_updates,
    clip_by_global_norm,
    compressed_gradients,
    constant,
    cosine_warmup,
    global_norm,
    int8_compress,
    int8_decompress,
    linear_warmup,
    sgd_momentum,
)
from repro_torch.optim.compress import (
    compression_ratio,
    ef_init,
    topk_compress,
    topk_decompress,
)

hypothesis = pytest.importorskip(
    "hypothesis",
    reason="optional test dep (pip install repro[test]); skip, don't abort "
           "collection")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

RTOL = 1e-6


def quad_setup():
    params = {"w": torch.tensor([3.0, -2.0, 1.0]), "b": torch.tensor([0.5])}

    def grad(p):
        return {k: 2 * v for k, v in p.items()}

    def loss(p):
        return float(sum(torch.sum(v ** 2) for v in p.values()))
    return params, grad, loss


@pytest.mark.parametrize("opt", [adamw(1e-1, weight_decay=0.0),
                                 sgd_momentum(5e-2)], ids=["adamw", "sgd"])
@pytest.mark.parametrize("fused", [False, True],
                         ids=["update+apply", "step"])
def test_optimizers_converge_on_quadratic(opt, fused):
    params, grad, loss = quad_setup()
    state = opt.init(params)
    for _ in range(200):
        g = grad(params)
        if fused:
            params, state = opt.step(g, state, params)
        else:
            updates, state = opt.update(g, state, params)
            params = apply_updates(params, updates)
    assert loss(params) < 1e-3


def test_adamw_weight_decay_shrinks_params():
    params = {"w": torch.ones(4)}
    opt = adamw(1e-2, weight_decay=0.5)
    state = opt.init(params)
    zero_g = {"w": torch.zeros(4)}
    for _ in range(50):
        updates, state = opt.update(zero_g, state, params)
        params = apply_updates(params, updates)
    assert float(params["w"].abs().max()) < 1.0


def test_adamw_bf16_params_fp32_moments():
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    opt = adamw(1e-2)
    state = opt.init(params)
    assert state["mu"]["w"].dtype == torch.float32
    g = {"w": torch.full((4,), 0.1, dtype=torch.bfloat16)}
    updates, state = opt.update(g, state, params)
    assert apply_updates(params, updates)["w"].dtype == torch.bfloat16
    new, _ = opt.step(g, opt.init(params), params)
    assert new["w"].dtype == torch.bfloat16


def test_schedules():
    lw = linear_warmup(1.0, 10)
    assert float(lw(torch.tensor(5))) == pytest.approx(0.5)
    assert float(lw(torch.tensor(100))) == pytest.approx(1.0)
    cw = cosine_warmup(1.0, 10, 110, final_frac=0.1)
    assert float(cw(torch.tensor(5))) == pytest.approx(0.5)
    assert float(cw(torch.tensor(110))) == pytest.approx(0.1, abs=1e-5)


def test_clip_by_global_norm():
    tree = {"a": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(tree, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    small = {"a": torch.full((4,), 0.01)}
    out, _ = clip_by_global_norm(small, 1.0)
    torch.testing.assert_close(out["a"], small["a"], rtol=0, atol=0)


@settings(max_examples=50, deadline=None)
@given(st.lists(st.floats(-100, 100, allow_nan=False), min_size=1,
                max_size=32))
def test_int8_roundtrip_bounded_error(vals):
    x = torch.tensor(vals, dtype=torch.float32)
    q, scale = int8_compress(x)
    recon = int8_decompress(q, scale)
    assert float((recon - x).abs().max()) <= float(scale) * 0.5 + 1e-6


def test_topk_keeps_largest():
    x = torch.tensor([0.1, -5.0, 0.2, 3.0])
    vals, idx = topk_compress(x, frac=0.5)
    recon = topk_decompress(vals, idx, x.shape)
    assert recon.tolist() == [0.0, -5.0, 0.0, 3.0]


def test_error_feedback_preserves_signal():
    """With EF, repeated compression of a constant gradient transmits the
    full magnitude over time (sum of recon ≈ n·g)."""
    g = {"w": torch.tensor([1e-4, 1.0])}
    ef = ef_init(g)
    total = torch.zeros(2)
    n = 200
    for _ in range(n):
        recon, ef = compressed_gradients(g, ef, method="int8")
        total = total + recon["w"]
    bucket = float(g["w"].abs().max()) / 127.0
    np.testing.assert_allclose((total / n).numpy(), g["w"].numpy(),
                               rtol=0.05, atol=1.5 * bucket / n)


# ---------------------------------------------------------------------------
# against the JAX package on the same numpy trees
# ---------------------------------------------------------------------------

def numpy_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"layers": {"w": rng.standard_normal((3, 8, 5)) * scale,
                       "b": rng.standard_normal((3, 5)) * scale},
            "embed": rng.standard_normal((16, 8)) * scale}


def as_jax(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                  tree)


def as_port(tree):
    return pytree.tree_map(lambda a: torch.tensor(a, dtype=torch.float32),
                           tree)


def assert_trees_close(got, want, rtol=RTOL, atol=0.0):
    want = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = dict(flatten_with_path(got))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path].numpy(), w, rtol=rtol,
                                   atol=atol + 1e-7 * np.abs(w).max(),
                                   err_msg=path)


@pytest.mark.parametrize("make", [
    lambda m: m.adamw(1e-2),
    lambda m: m.adamw(m.cosine_warmup(1e-2, 2, 6), weight_decay=0.0),
    lambda m: m.sgd_momentum(5e-2),
    lambda m: m.sgd_momentum(m.linear_warmup(5e-2, 3), nesterov=True),
], ids=["adamw", "adamw-cosine", "sgd", "sgd-nesterov-warmup"])
def test_optimizer_trajectory_matches_the_reference(make):
    import repro_torch.optim as P

    jopt, popt = make(J), make(P)
    jp, pp = as_jax(numpy_tree(0)), as_port(numpy_tree(0))
    js, ps = jopt.init(jp), popt.init(pp)
    fused = as_port(numpy_tree(0))
    fs = popt.init(fused)
    for i in range(6):
        g = numpy_tree(10 + i, scale=0.1)
        ju, js = jopt.update(as_jax(g), js, jp)
        jp = J.apply_updates(jp, ju)
        pu, ps = popt.update(as_port(g), ps, pp)
        assert_trees_close(pu, ju)
        pp = apply_updates(pp, pu)
        fused, fs = popt.step(as_port(g), fs, fused)
    assert_trees_close(pp, jp)
    assert_trees_close(fused, jp)
    for key in js:
        if key == "step":
            assert int(ps["step"]) == int(js["step"]) == 6
        else:
            assert_trees_close(ps[key], js[key])
            assert_trees_close(fs[key], js[key])


def test_step_slices_large_leaves_like_the_whole(monkeypatch):
    """The fused step walks a leaf above ``ROW_STEP_ELEMENTS`` in slices
    of rows (one row of ``w``, two of ``embed``): the same values as the
    whole leaf."""
    from repro_torch.optim import base

    opt = adamw(1e-2)
    params, g = as_port(numpy_tree(1)), as_port(numpy_tree(2, 0.1))
    whole = opt.step(g, opt.init(params), params)
    monkeypatch.setattr(base, "ROW_STEP_ELEMENTS", 16)
    sliced = opt.step(g, opt.init(params), params)
    for a, b in zip(pytree.tree_leaves(whole), pytree.tree_leaves(sliced)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)), ("linear_warmup", (1.0, 10)),
    ("cosine_warmup", (1.0, 10, 110)), ("cosine_warmup", (2e-3, 5, 20, 0.0)),
], ids=str)
def test_schedule_matches_the_reference(name, args):
    import repro_torch.optim.schedules as P

    jfn, pfn = getattr(J, name)(*args), getattr(P, name)(*args)
    for s in range(0, 130, 3):
        want = float(jfn(jnp.int32(s)))
        got = float(pfn(torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=RTOL, abs=1e-9), s


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clips", "passes"])
def test_clip_matches_the_reference(max_norm):
    tree = numpy_tree(3)
    jout, jnorm = J.clip_by_global_norm(as_jax(tree), max_norm)
    pout, pnorm = clip_by_global_norm(as_port(tree), max_norm)
    assert float(pnorm) == pytest.approx(float(jnorm), rel=RTOL)
    assert_trees_close(pout, jout)


@pytest.mark.parametrize("method", ["int8", "topk", "none"])
def test_compressed_gradients_match_the_reference(method):
    # distinct magnitudes: no top-k ties
    jef, pef = jax_ef_init(as_jax(numpy_tree(0))), ef_init(
        as_port(numpy_tree(0)))
    for i in range(4):
        g = numpy_tree(20 + i)
        jout, jef = J.compressed_gradients(as_jax(g), jef, method=method,
                                           topk_frac=0.1)
        pout, pef = compressed_gradients(as_port(g), pef, method=method,
                                         topk_frac=0.1)
        assert_trees_close(pout, jout, atol=1e-6)
        assert_trees_close(pef.residual, jef.residual, atol=1e-6)


def test_int8_codes_and_topk_indices_match_the_reference():
    x = np.random.default_rng(5).standard_normal(300).astype(np.float32)
    jq, js = J.int8_compress(jnp.asarray(x))
    pq, ps = int8_compress(torch.from_numpy(x))
    assert pq.dtype == torch.int8
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    assert float(ps) == pytest.approx(float(js), rel=RTOL)
    jv, ji = J.topk_compress(jnp.asarray(x), 0.05)
    pv, pi = topk_compress(torch.from_numpy(x), 0.05)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        topk_decompress(pv, pi, (300,)).numpy(),
        np.asarray(jax_topk_decompress(jv, ji, (300,))))


def test_compression_ratio():
    assert compression_ratio("int8", torch.bfloat16) == 0.5
    assert compression_ratio("int8", torch.float32) == 0.25
    assert compression_ratio("topk", torch.bfloat16, 0.01) == \
        pytest.approx(0.04)
    assert compression_ratio("none") == 1.0


def test_constant_schedule_is_a_device_scalar():
    lr = constant(3e-4)(torch.tensor(7, dtype=torch.int32))
    assert lr.dtype == torch.float32 and lr.dim() == 0
