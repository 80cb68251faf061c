"""Port parity: training — ``Model.loss`` and its gradients, the flash
attention and SSD scan kernels under autograd, and ``build_train_step``.

Both packages start from one set of weights: the reference's
``Model.init(PRNGKey(0))`` (or ``init_train_state``) through numpy into
``bridge.params_from_jax`` / ``bridge.train_state_from_jax``.  Configs are
``reduced()`` (2 layers, d 64; the hybrid 4) in float32, batches are drawn
with numpy from a seed.  On the CPU the kernel wrappers run their plain
versions through the same ``torch.autograd.Function``s the card runs, so
these tests run the backward code the card runs.

Tolerances (float32 on both sides, different summation orders between XLA
and PyTorch):

* losses within 1e-5 relative;
* each gradient leaf within 1e-4 of its largest magnitude;
* kernel backward against autograd through the plain versions: 1e-5 (the
  same float32 arithmetic, differently grouped);
* after AdamW steps the parameters within 1e-5 of each leaf's largest
  magnitude, but for at most 0.1% of all parameter elements, which are
  held within ``2 * lr``: AdamW moves an element by about ``±lr`` per step
  (its first step by exactly ``±lr``, ``m̂/√v̂ = sign(g)``), so an element
  whose gradient lies within the two packages' noise of zero (a key bias's
  gradient is zero in exact arithmetic) may move the other way.  A step
  that is missing, has its sign flipped or drops weight decay moves far
  more than 0.1% of the elements.  The moments within 1e-5 of their
  largest magnitude;
* after SGD-momentum steps, which have no such sign sensitivity, every
  leaf within 1e-5 of its largest magnitude;
* with int8 compression an element within that noise of a quantization
  bucket's midpoint reconstructs one bucket apart, which moves the
  clipping norm, and so every later gradient, by ~1e-5 of itself.  A
  residual is a difference of two values ~127 buckets large, at most half
  a bucket itself, so it carries that noise 254 times magnified: the
  residual is held within 0.03 of its largest magnitude (254 x 1e-4) and
  the moments within 1e-4 of theirs, but for at most 1% of the elements
  (one, in a small leaf), which are held within one bucket (for the
  residual about twice its largest magnitude, held at 2.1 times it; for a
  moment its largest magnitude).
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
from repro.models.layers import chunked_causal_attention as jax_chunked
from repro.models.model import Model as JaxModel
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro.optim import adamw as jax_adamw
from repro.optim import sgd_momentum as jax_sgd_momentum
from repro.runtime.train_loop import build_train_step as jax_build
from repro.runtime.train_loop import init_train_state as jax_init
from repro_torch.bridge import params_from_jax, train_state_from_jax
from repro_torch.checkpoint.serialization import flatten_with_path
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import reduced as port_reduced
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models import Model
from repro_torch.models.layers import chunked_causal_attention
from repro_torch.models.ssm import ssd_chunked
from repro_torch.optim import adamw, sgd_momentum
from repro_torch.runtime.train_loop import build_train_step, value_and_grad

FAMILIES = ("qwen2-1.5b", "mamba2-2.7b", "zamba2-7b", "qwen3-moe-235b-a22b",
            "pixtral-12b", "musicgen-medium")
B, S, CHUNK = 2, 16, 8
LR = 1e-3


def configs(name):
    return (dataclasses.replace(reduced(get_config(name)), dtype="float32"),
            dataclasses.replace(port_reduced(port_config(name)),
                                dtype="float32"))


def make_batch(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks > 1 else (b, s)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape),
             "targets": rng.integers(0, cfg.vocab_size, shape)}
    if cfg.frontend == "vlm_stub":
        batch["frontend_embed"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v, jnp.int32 if k != "frontend_embed"
                            else jnp.float32) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def by_path(tree):
    return {p: v.detach().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for p, v in flatten_with_path(tree)}


def jax_by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    jcfg, cfg = configs(request.param)
    jm = JaxModel(jcfg, attn_chunk=CHUNK, loss_chunk=CHUNK)
    jp = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
    jb, tb = make_batch(cfg, 1)
    (jloss, jmet), jgrads = jax.jit(
        jax.value_and_grad(jm.loss, has_aux=True))(jp, jb)
    return dict(cfg=cfg, params=params, batch=tb, jloss=float(jloss),
                jmet={k: float(v) for k, v in jmet.items()},
                jgrads=jax_by_path(jgrads))


def test_loss_and_every_gradient_match_the_reference(family):
    model = Model(family["cfg"], attn_chunk=CHUNK, loss_chunk=CHUNK)
    loss, metrics, grads = value_and_grad(model, family["params"],
                                          family["batch"])
    assert float(loss) == pytest.approx(family["jloss"], rel=1e-5)
    for k in ("xent", "moe_aux"):
        assert float(metrics[k]) == pytest.approx(family["jmet"][k],
                                                  rel=1e-5, abs=1e-7)
    got = by_path(grads)
    assert set(got) == set(family["jgrads"])
    for path, want in family["jgrads"].items():
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[path], want, rtol=0,
                                   atol=1e-4 * scale + 1e-12, err_msg=path)


def test_remat_on_and_off_give_equal_gradients(family):
    out = {}
    for remat in (True, False):
        model = Model(family["cfg"], attn_chunk=CHUNK, loss_chunk=CHUNK,
                      remat=remat)
        out[remat] = value_and_grad(model, family["params"],
                                    family["batch"])
    assert float(out[True][0]) == float(out[False][0])
    for a, b in zip(pytree.tree_leaves(out[True][2]),
                    pytree.tree_leaves(out[False][2])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_moe_gradients_reach_the_router_and_every_expert():
    _, cfg = configs("qwen3-moe-235b-a22b")
    model = Model(cfg, attn_chunk=CHUNK, loss_chunk=CHUNK)
    params = model.init(torch.Generator().manual_seed(0))
    _, metrics, grads = value_and_grad(model, params, make_batch(cfg, 2)[1])
    assert float(metrics["moe_aux"]) > 0
    moe = grads["layers"]["moe"]
    assert moe["router"].abs().sum() > 0
    for name in ("wu", "wd", "wg"):
        # every expert of every layer received a gradient
        assert (moe[name].abs().flatten(2).sum(-1) > 0).all(), name


def qkv(seed, b=2, s=24, h=4, kv=2, hd=16):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd),
                          (b, s, h, hd))]


@pytest.mark.parametrize("s,chunk", [(24, 8), (24, 24), (20, 8)], ids=str)
def test_flash_attention_backward_equals_autograd_through_plain(s, chunk):
    q, k, v, g = qkv(s + chunk, s=s)
    for x in (q, k, v):
        x.requires_grad_()
    got = torch.autograd.grad(flash_attention(q, k, v, chunk), (q, k, v), g)
    want = torch.autograd.grad(
        chunked_causal_attention(q, k, v, chunk=chunk), (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_chunked_attention_matches_the_reference():
    q, k, v, _ = qkv(5, s=20)
    want = jax_chunked(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                       chunk=8)
    got = chunked_causal_attention(q, k, v, chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def ssd_inputs(seed, b=2, s=20, H=3, P=16, N=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, H)) - 2)).astype(
        np.float32)
    A = -np.linspace(1.0, 4.0, H).astype(np.float32)
    Bm = rng.standard_normal((b, s, N)).astype(np.float32)
    Cm = rng.standard_normal((b, s, N)).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["y-only", "y-and-state"])
def test_ssd_scan_backward_equals_autograd_through_plain(with_state):
    args = [a.requires_grad_() for a in ssd_inputs(3)]
    gen = torch.Generator().manual_seed(0)
    y, state = ssd_scan(*args, chunk=8)
    gy = torch.randn(y.shape, generator=gen)
    gs = torch.randn(state.shape, generator=gen) if with_state else None

    def objective(y, state):
        return (y * gy).sum() + ((state * gs).sum() if with_state else 0)
    got = torch.autograd.grad(objective(y, state), args)
    want = torch.autograd.grad(objective(*ssd_scan_ref(*args, chunk=8)),
                               args)
    assert got[1].dtype == got[2].dtype == torch.float32
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("initial", [False, True], ids=["zero", "given"])
def test_ssd_chunked_matches_the_reference(initial):
    x, dt, A, Bm, Cm = ssd_inputs(4, s=20)
    h0 = (np.random.default_rng(1).standard_normal((2, 3, 16, 16))
          .astype(np.float32) if initial else None)
    jy, jh = jax_ssd_chunked(*(jnp.asarray(a.numpy())
                               for a in (x, dt, A, Bm, Cm)), 8,
                             None if h0 is None else jnp.asarray(h0))
    y, h = ssd_chunked(x, dt, A, Bm, Cm, 8,
                       None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=1e-4)


def test_flash_attention_vmap_rule_equals_a_loop():
    q, k, v, _ = qkv(7)
    qs = torch.stack([q, q * 0.5, -q])
    out = torch.func.vmap(flash_attention, in_dims=(0, None, None))(qs, k, v)
    loop = torch.stack([flash_attention(x, k, v) for x in qs])
    torch.testing.assert_close(out, loop, rtol=0, atol=0)


@pytest.mark.parametrize("a_mapped", [False, True],
                         ids=["A-shared", "A-mapped"])
def test_ssd_scan_vmap_rule_equals_a_loop(a_mapped):
    x, dt, A, Bm, Cm = ssd_inputs(8)
    xs = torch.stack([x, 2 * x])
    As = torch.stack([A, 0.5 * A]) if a_mapped else A
    dims = (0, None, 0 if a_mapped else None, None, None)
    y, st = torch.func.vmap(ssd_scan, in_dims=dims)(xs, dt, As, Bm, Cm)
    for i in range(2):
        yi, si = ssd_scan(xs[i], dt, As[i] if a_mapped else A, Bm, Cm)
        torch.testing.assert_close(y[i], yi, rtol=0, atol=0)
        torch.testing.assert_close(st[i], si, rtol=0, atol=0)


def test_grad_inside_vmap_equals_per_branch_grads():
    """``SpeculativeTrainer``'s composition: ``torch.func.grad`` per branch
    inside ``torch.func.vmap``, through both kernels' vmap rules."""
    for name in ("qwen2-1.5b", "zamba2-7b"):
        _, cfg = configs(name)
        model = Model(cfg, attn_chunk=CHUNK, loss_chunk=CHUNK)
        params = model.init(torch.Generator().manual_seed(0))
        toks = torch.stack([make_batch(cfg, i)[1]["tokens"]
                            for i in range(2)])

        def loss(p, t):
            return model.loss(p, {"tokens": t, "targets": t})[0]
        stacked = pytree.tree_map(lambda x: torch.stack([x, 1.01 * x]),
                                  params)
        got = torch.func.vmap(torch.func.grad(loss))(stacked, toks)
        for i in range(2):
            want = torch.func.grad(loss)(
                pytree.tree_map(lambda x: x[i], stacked), toks[i])
            for a, b in zip(pytree.tree_leaves(got),
                            pytree.tree_leaves(want)):
                torch.testing.assert_close(a[i], b, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def dense():
    jcfg, cfg = configs("qwen2-1.5b")
    return (jcfg, JaxModel(jcfg, attn_chunk=CHUNK, loss_chunk=CHUNK), cfg,
            Model(cfg, attn_chunk=CHUNK, loss_chunk=CHUNK))


def three_steps(dense, jopt, opt, accum, compress=None):
    """The reference's and the port's states by path after 3 steps from
    one bridged ``TrainState``; every metric of every step held within
    1e-5 relative."""
    jcfg, jm, cfg, model = dense
    js = jax_init(jm, jopt, jax.random.PRNGKey(0), compress=compress)
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, js),
                                 device="cpu")
    jstep = jax.jit(jax_build(jm, jopt, accum_steps=accum, clip_norm=1.0,
                              compress=compress))
    step = build_train_step(model, opt, accum_steps=accum, clip_norm=1.0,
                            compress=compress)
    for i in range(3):
        jb, tb = make_batch(cfg, 10 + i, b=4)
        js, jmet = jstep(js, jb)
        state, met = step(state, tb)
        for k in jmet:
            assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-5,
                                                  abs=1e-7), (i, k)
    want, got = jax_by_path(js), by_path(state)
    assert set(got) == set(want)
    assert int(state.step) == 3 and int(state.opt_state["step"]) == 3
    return want, got


def off_by(got, want, frac):
    """Elements of ``got`` further than ``frac`` of ``want``'s largest
    magnitude from it."""
    scale = np.abs(want).max() + 1e-12
    return np.abs(got.astype(np.float64) - want) > frac * scale


@pytest.mark.parametrize("accum,compress", [(1, None), (2, None),
                                            (1, "int8")], ids=str)
def test_three_steps_match_the_reference(dense, accum, compress):
    want, got = three_steps(dense, jax_adamw(LR), adamw(LR), accum, compress)
    params = [p for p in want if p.startswith(".params")]
    flipped = sum(int(off_by(got[p], want[p], 1e-5).sum()) for p in params)
    assert flipped <= 1e-3 * sum(want[p].size for p in params), flipped
    for path, w in want.items():
        scale = np.abs(w).max() + 1e-12
        if path.startswith(".params"):
            atol = 2 * LR
        elif compress and path != ".opt_state['step']":
            # an element at a bucket's midpoint: few, and within a bucket
            off = off_by(got[path], w,
                         0.03 if path.startswith(".ef") else 1e-4)
            assert off.sum() <= max(1, 0.01 * off.size), path
            atol = (2.1 if path.startswith(".ef") else 1) * scale
        else:
            atol = 1e-5 * scale
        np.testing.assert_allclose(got[path].astype(np.float64), w,
                                   rtol=0, atol=atol, err_msg=path)


@pytest.mark.parametrize("accum", [1, 2])
def test_three_sgd_momentum_steps_match_the_reference(dense, accum):
    want, got = three_steps(dense, jax_sgd_momentum(0.1), sgd_momentum(0.1),
                            accum)
    for path, w in want.items():
        assert not off_by(got[path], w, 1e-5).any(), path


def test_step_never_writes_into_its_input_state(dense):
    _, _, cfg, model = dense
    opt = adamw(LR)
    state = train_state_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_init(dense[1], jax_adamw(LR),
                             jax.random.PRNGKey(0), compress="int8")),
        device="cpu")
    leaves = pytree.tree_leaves(state)
    before = [(x.clone(), x._version) for x in leaves]
    step = build_train_step(model, opt, accum_steps=2, compress="int8")
    new, _ = step(state, make_batch(cfg, 3, b=4)[1])
    for x, (copy, version) in zip(leaves, before):
        assert x._version == version
        assert torch.equal(x, copy)
    assert not any(a is b for a, b in zip(pytree.tree_leaves(new), leaves))


def test_grad_shardings_raise_on_one_card(dense):
    """``grad_shardings`` on the single-device plan (``param_shardings``'
    tree of ``None``) is accepted and changes nothing: the accumulator of
    an ``accum_steps=2`` step lies where it lay."""
    from repro_torch.distributed import SINGLE_DEVICE, param_shardings
    _, _, cfg, model = dense
    opt = adamw(LR)
    state = train_state_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_init(dense[1], jax_adamw(LR),
                             jax.random.PRNGKey(0))), device="cpu")
    layout = param_shardings(cfg, SINGLE_DEVICE, state.params)
    assert all(x is None for x in jax.tree_util.tree_leaves(
        layout, is_leaf=lambda x: x is None))
    batch = make_batch(cfg, 4, b=4)[1]
    want, wmet = build_train_step(model, opt, accum_steps=2)(state, batch)
    got, met = build_train_step(model, opt, accum_steps=2,
                                grad_shardings=layout)(state, batch)
    assert {k: float(v) for k, v in met.items()} == {
        k: float(v) for k, v in wmet.items()}
    got, want = by_path(got), by_path(want)
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)
