"""Port parity: the SSM and hybrid families trained over a (data, model)
mesh on the CPU, their parameters stored as blocks.

The Mamba2 block splits over the model positions by its SSD heads
(``models/sharded.py::mamba``): each position takes its heads' columns of
``in_proj`` (z, x and dt) and all of B and C, its heads' conv channels
and B's and C's, scans its heads, and the gated output norm sums its f32
squares over the positions.  The hybrid's shared block runs its attention
heads and d_ff slices shard-locally too.  One host process drives every
position (``["cpu"] * n`` meshes).

Weights come from the port's seeded init, handed to the reference as jnp
arrays; configs are ``reduced()`` in float32 (mamba2: 8 SSD heads of 16,
N 16; zamba2 at 3 layers: a remat'd group of two Mamba2 layers and the
shared block, then a tail layer outside remat).  Batches are drawn
with numpy from a seed (``tests/test_torch_train.py``'s helpers).

Tolerances are ``tests/test_torch_dist_train.py``'s.  Three steps over
each mesh: every step's metrics (loss, grad norm, xent) against the
reference's single-device ``build_train_step`` within 1e-5 relative; the
first step's gradients against the port's single device within 1e-5 of
each leaf's largest magnitude; the final state against the port's single
device's three steps: the parameters by ``tests/test_torch_train.py``'s
rule (within 1e-5 of each leaf's largest magnitude but for 0.1% of the
elements, held within 2 lr), the moments within 1e-4 of their largest
magnitude.  A moment after three steps sums three clipped gradients, each
within 1e-5 of the largest gradient: measured, up to 5.6e-5 (zamba2 over
(1, 3)) where qwen2's and granite's stay within 1e-5.  The states are
held against the port's single device, not the reference's, as
``tests/test_torch_dist_train.py`` holds granite's: the port's single
device and the reference already differ in the moments after three steps
(mamba2: one element of the conv weights' at 1.8e-5 of its largest;
zamba2: 160 elements of the shared MLP's at up to 1.4e-4), the f32 noise
of their summation orders.  The
gradients of B's and C's columns and channels, which every model position
uses, against the port's single device within 1e-5 of their largest
magnitude; the cross-position gated norm against the whole row's within
1e-6 relative (the same f32 squares, summed in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_dist_train as dist
import test_torch_train as port_train
from repro.configs import get_config
from repro.configs.base import reduced
from repro.models.model import Model as JaxModel
from repro.optim import adamw as jax_adamw
from repro.runtime.train_loop import TrainState as JaxTrainState
from repro.runtime.train_loop import build_train_step as jax_build
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import reduced as port_reduced
from repro_torch.distributed import blocked
from repro_torch.distributed.sharding import mamba_ranges, shard_params
from repro_torch.models import Model
from repro_torch.models import layers as L
from repro_torch.models import sharded
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import (
    TrainState,
    build_train_step,
    sharded_value_and_grad,
    value_and_grad,
)

CHUNK, LR = port_train.CHUNK, port_train.LR
#: the meshes held: (data, model); (1, 3) splits 8 SSD heads 3, 3, 2 (and
#: zamba2's 4 attention heads 2, 1, 1)
SHAPES = ((1, 2), (2, 2), (1, 4), (1, 3))


def configs(name):
    """Reduced, float32; zamba2 at 3 layers (reduced() gives it at least
    4): one remat'd group of two Mamba2 layers and the shared block, then
    a tail layer outside remat."""
    kw = dict(dtype="float32")
    if name == "zamba2-7b":
        kw["num_layers"] = 3
    return (dataclasses.replace(reduced(get_config(name)), **kw),
            dataclasses.replace(port_reduced(port_config(name)), **kw))


def gathered(tree):
    """Every leaf whole (a blocked one's blocks gathered)."""
    return blocked.map_leaves(
        lambda x: x if x is None else blocked.whole(x), tree)


def three_port_steps(model, state, cfg):
    """Three AdamW steps (clip 1.0) on the three-step batches: (metrics per
    step, the final state by path)."""
    step = build_train_step(model, adamw(LR), clip_norm=1.0)
    mets = []
    for i in range(3):
        state, met = step(state, port_train.make_batch(cfg, 10 + i, b=4)[1])
        mets.append({k: float(v) for k, v in met.items()})
    return mets, port_train.by_path(gathered(state))


@pytest.fixture(scope="module", params=["mamba2-2.7b", "zamba2-7b"])
def family(request):
    """The port's seeded weights; the reference's three single-device AdamW
    steps (clip 1.0) from them, its metrics per step; the port's single
    device's three steps, its final state by path; the port's single
    device's gradients on the first batch."""
    jcfg, cfg = configs(request.param)
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    jm = JaxModel(jcfg, attn_chunk=CHUNK, loss_chunk=CHUNK)
    jp = dist.to_jax(params)
    jopt = jax_adamw(LR)
    js = JaxTrainState(params=jp, opt_state=jopt.init(jp), ef=None,
                       step=jnp.zeros((), jnp.int32))
    jstep = jax.jit(jax_build(jm, jopt, clip_norm=1.0))
    jmets = []
    for i in range(3):
        js, jmet = jstep(js, port_train.make_batch(cfg, 10 + i, b=4)[0])
        jmets.append({k: float(v) for k, v in jmet.items()})
    one = Model(cfg, attn_chunk=CHUNK, loss_chunk=CHUNK)
    state = TrainState(params=params, opt_state=adamw(LR).init(params),
                       ef=None, step=torch.zeros((), dtype=torch.int32))
    _, want = three_port_steps(one, state, cfg)
    grads = value_and_grad(one, params,
                           port_train.make_batch(cfg, 10, b=4)[1])[2]
    return cfg, params, jmets, want, port_train.by_path(grads)


def blocked_state(cfg, plan, params):
    """The state as ``init_train_state`` stores it over ``plan``: the
    parameters as blocks, AdamW's moments made from them."""
    opt = adamw(LR)
    p = shard_params(cfg, plan, params)
    return TrainState(params=p, opt_state=shard_params(cfg, plan,
                                                       opt.init(p)),
                      ef=None, step=torch.zeros((), dtype=torch.int32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_three_steps_over_the_mesh_match_one_device(family, shape):
    cfg, params, jmets, want, want_grads = family
    plan = dist.plan(shape)
    model = Model(cfg, plan=plan, attn_chunk=CHUNK, loss_chunk=CHUNK)
    state = blocked_state(cfg, plan, params)
    # a model axis of 3 divides none of in_proj's dims: it is stored
    # whole, and the three positions take their uneven heads from it
    assert blocked.is_blocked(state.params["layers"]["mamba"][
        "in_proj"]) == (shape != (1, 3))
    grads = sharded_value_and_grad(model, state.params,
                                   port_train.make_batch(cfg, 10, b=4)[1])[2]
    for path, g in port_train.by_path(gathered(grads)).items():
        assert not port_train.off_by(g, want_grads[path], 1e-5).any(), path

    mets, got = three_port_steps(model, state, cfg)
    for i, (m, w) in enumerate(zip(mets, jmets)):
        for k in w:
            assert m[k] == pytest.approx(w[k], rel=1e-5, abs=1e-7), (i, k)
    params = [p for p in want if p.startswith(".params")]
    flipped = sum(int(port_train.off_by(got[p], want[p], 1e-5).sum())
                  for p in params)
    assert flipped <= 1e-3 * sum(want[p].size for p in params), flipped
    for path, w in want.items():
        if path.startswith(".params"):
            atol = 2 * LR
        elif path.startswith(".opt_state['mu']") or path.startswith(
                ".opt_state['nu']"):
            atol = 1e-4 * (np.abs(w).max() + 1e-12)
        else:
            atol = 0
        np.testing.assert_allclose(got[path].astype(np.float64), w, rtol=0,
                                   atol=atol, err_msg=path)


def test_b_and_c_gradients_sum_over_the_model_positions():
    """Every model position uses all of B's and C's ``in_proj`` columns and
    conv channels; their gradients over a (1, 4) mesh, stored as blocks,
    are the single device's (the sum of the four positions' parts)."""
    _, cfg = configs("mamba2-2.7b")
    params = Model(cfg).init(torch.Generator().manual_seed(1))
    batch = port_train.make_batch(cfg, 4, b=2)[1]
    one = Model(cfg, attn_chunk=CHUNK, loss_chunk=CHUNK)
    _, _, want = value_and_grad(one, params, batch)
    plan = dist.plan((1, 4))
    model = Model(cfg, plan=plan, attn_chunk=CHUNK, loss_chunk=CHUNK)
    _, _, got = sharded_value_and_grad(model, shard_params(cfg, plan, params),
                                       batch)
    got = gathered(got)
    di, n = cfg.ssm_d_inner, 2 * cfg.ssm_state
    # B's and C's columns of in_proj follow z's and x's; their conv
    # channels follow x's
    for leaf, dim, start in (("in_proj", 2, 2 * di), ("conv_w", 1, di),
                             ("conv_b", 1, di)):
        w = want["layers"]["mamba"][leaf].narrow(dim, start, n).numpy()
        g = got["layers"]["mamba"][leaf].narrow(dim, start, n).numpy()
        assert np.abs(w).max() > 0, leaf
        assert not port_train.off_by(g, w, 1e-5).any(), leaf
    # and each rank's ranges of in_proj cover every column exactly once,
    # B's and C's four times
    cover = np.zeros(want["layers"]["mamba"]["in_proj"].shape[-1], int)
    for r in range(4):
        for start, size in mamba_ranges(cfg, "in_proj", r, 4):
            cover[start:start + size] += 1
    assert (cover[2 * di:2 * di + n] == 4).all()
    assert (np.delete(cover, np.s_[2 * di:2 * di + n]) == 1).all()


@pytest.mark.parametrize("tp", [2, 3])
def test_gated_norm_over_positions_is_the_whole_rows(tp):
    """``sharded.gated_rms_norm`` over a row split into ``tp`` uneven
    slices against ``layers.gated_rms_norm`` on the whole row."""
    rng = np.random.default_rng(tp)
    y, z = (torch.from_numpy(rng.standard_normal((2, 5, 40)).astype(
        np.float32)) for _ in range(2))
    w = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    want = L.gated_rms_norm(y, z, w, 1e-5)
    from repro_torch.distributed.mesh import split_range
    cuts = [split_range(40, tp, r) for r in range(tp)]
    parts = sharded.gated_rms_norm([y[..., a:a + n] for a, n in cuts],
                                   [z[..., a:a + n] for a, n in cuts],
                                   [w[a:a + n] for a, n in cuts], 1e-5, 40)
    torch.testing.assert_close(torch.cat(parts, dim=-1), want, rtol=1e-6,
                               atol=1e-7)


def test_too_many_model_positions_for_the_heads_raise():
    _, cfg = configs("mamba2-2.7b")
    with pytest.raises(ValueError, match="SSD heads"):
        mamba_ranges(cfg, "in_proj", cfg.ssm_heads, cfg.ssm_heads + 1)
