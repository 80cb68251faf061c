"""Port parity: the SSM (Mamba2) family's prefill and decode against JAX.

Both packages run ``reduced(mamba2-2.7b)`` at float32 from one set of
weights: the JAX package's ``Model.init(PRNGKey(0))``, leaf by leaf
through numpy into ``params_from_jax``.  The port's prefill scans through
the SSD scan wrapper (its plain version on the CPU), the JAX one through
``ssd_chunked``.  Tolerance 1e-4: float32 on both sides, different
summation orders and chunkings through two layers of residual growth.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import reduced
from repro.models.model import Model as JaxModel
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import ArchConfig as PortArchConfig
from repro_torch.configs.base import reduced as port_reduced
from repro_torch.models import Model
from repro_torch.models import decode as port_decode

TOL = 1e-4
NAME = "mamba2-2.7b"


def configs():
    return (dataclasses.replace(reduced(get_config(NAME)), dtype="float32"),
            dataclasses.replace(port_reduced(port_config(NAME)),
                                dtype="float32"))


@functools.lru_cache(maxsize=None)
def reference():
    """The JAX model at float32 and its weights as numpy."""
    jcfg, _ = configs()
    jmodel = JaxModel(jcfg, remat=False)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    return jmodel, jax.tree_util.tree_map(np.asarray, params)


def both():
    jmodel, weights = reference()
    return (jmodel, jax.tree_util.tree_map(jnp.asarray, weights),
            Model(configs()[1]), params_from_jax(weights, device="cpu"))


def prompt(seed, b=2, s=21):
    return np.random.default_rng(seed).integers(0, configs()[0].vocab_size,
                                                (b, s))


def close_cache(pcache, jcache):
    assert set(pcache) == set(jcache) == {"conv", "ssm"}
    for k in jcache:
        assert tuple(pcache[k].shape) == jcache[k].shape
        np.testing.assert_allclose(pcache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=TOL, atol=TOL)


def test_config_copy_matches_the_reference():
    assert dataclasses.asdict(port_config(NAME)) == \
        dataclasses.asdict(get_config(NAME))
    jcfg, pcfg = configs()
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert pcfg.ssm_heads == jcfg.ssm_heads and \
        pcfg.ssm_conv_dim == jcfg.ssm_conv_dim


def test_bridge_round_trips_and_init_has_the_reference_layout():
    _, weights = reference()
    pparams = params_from_jax(weights, device="cpu")
    flat = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(weights)[0]}
    pflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(pparams)[0]}
    assert set(pflat) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(pflat[k].numpy(), v)
        assert pflat[k].numpy().dtype == v.dtype
    # A_log, D and dt_bias stay f32 in a bf16 model, on both sides
    jcfg, pcfg = configs()
    jshapes = jax.eval_shape(
        JaxModel(dataclasses.replace(jcfg, dtype="bfloat16")).init,
        jax.random.PRNGKey(0))
    init = Model(dataclasses.replace(pcfg, dtype="bfloat16")).init(
        torch.Generator().manual_seed(0))
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)) for k, v
            in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    got = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)[6:])
           for k, v in jax.tree_util.tree_flatten_with_path(init)[0]}
    assert got == want


@pytest.mark.parametrize("s", [3, 16, 21])
def test_prefill_logits_and_caches_match_jax(s):
    """s = 3 is the shortest prompt (the conv state is its whole input);
    16 is two whole chunks of 8, 21 a ragged tail."""
    jmodel, jparams, pmodel, pparams = both()
    tokens = prompt(s, s=s)
    jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(tokens, jnp.int32))
    plogits, pcache = pmodel.prefill(pparams, torch.from_numpy(tokens))
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    close_cache(pcache, jcache)


def test_eight_decode_steps_match_jax_and_greedy_tokens_agree():
    jmodel, jparams, pmodel, pparams = both()
    tokens = prompt(1)
    jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(tokens, jnp.int32))
    plogits, pcache = pmodel.prefill(pparams, torch.from_numpy(tokens))
    pos = tokens.shape[1]
    jtoks, ptoks = [], []
    for _ in range(8):
        jt = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1))
        pt = plogits[:, -1].argmax(dim=-1).numpy()
        jtoks.append(jt.tolist())
        ptoks.append(pt.tolist())
        jlogits, jcache = jmodel.decode_step(
            jparams, jcache, jnp.asarray(jt[:, None], jnp.int32),
            jnp.full((2,), pos, jnp.int32))
        plogits, pcache = pmodel.decode_step(
            pparams, pcache, torch.from_numpy(pt[:, None]),
            torch.full((2,), pos, dtype=torch.int32))
        pos += 1
        np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits),
                                   rtol=TOL, atol=TOL)
        close_cache(pcache, jcache)
    assert ptoks == jtoks


def test_decode_step_is_out_of_place():
    _, _, pmodel, pparams = both()
    _, cache = pmodel.prefill(pparams, torch.from_numpy(prompt(2)))
    before = {k: (v.clone(), v.data_ptr()) for k, v in cache.items()}
    _, new = pmodel.decode_step(pparams, cache, torch.zeros(2, 1).long(),
                                torch.zeros(2, dtype=torch.int32))
    for k, (copy, ptr) in before.items():
        assert cache[k].data_ptr() == ptr and torch.equal(cache[k], copy)
        assert new[k].data_ptr() != ptr
        assert not torch.equal(new[k], copy)


def test_init_decode_state_matches_the_reference_specs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):   # no silent CPU
        Model(configs()[1]).init_decode_state(3, 10)
    jmodel, _ = reference()
    jstate = jmodel.init_decode_state(3, 10)
    pstate = Model(configs()[1]).init_decode_state(3, 10, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in pstate.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in jstate.items()}
    assert all(not v.any() for v in pstate.values())


def test_short_prompts_and_other_families_are_refused():
    _, _, pmodel, pparams = both()
    with pytest.raises(ValueError, match="at least 3"):
        pmodel.prefill(pparams, torch.zeros(1, 2).long())
    # the hybrid is served now (tests/test_torch_hybrid.py): its Model
    # builds, with the shared block; a family no package has is refused
    hybrid = PortArchConfig(name="h", family="hybrid", num_layers=4,
                            d_model=64, num_heads=4, num_kv_heads=2,
                            d_ff=128, vocab_size=64, ssm_state=16,
                            attn_every=2, dtype="float32")
    params = Model(hybrid).init(torch.Generator().manual_seed(0))
    assert params["shared"]["w_concat"].shape == (128, 64)
    other = dataclasses.replace(hybrid, family="rnn")
    with pytest.raises(NotImplementedError):
        Model(other)
    with pytest.raises(NotImplementedError):
        port_decode.decode_step(other, {}, {}, torch.zeros(1, 1).long(),
                                torch.zeros(1))
