"""Port parity: the parameter bridge and the dense prefill.

Both packages run from one set of weights: the JAX package's
``Model.init(PRNGKey(0))``, leaf by leaf through numpy into
``params_from_jax``.  The prefill's last-position logits and per-layer K/V
must agree at float32.  Tolerance 1e-4: float32 on both sides, with
matmul and softmax summation orders that differ between XLA and PyTorch,
through a few layers of residual growth.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import reduced
from repro.models.model import Model as JaxModel
from repro_torch.bridge import params_from_jax, tensor_from_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.configs import list_archs
from repro_torch.configs.base import reduced as port_reduced
from repro_torch.models import Model

TOL = 1e-4


def configs(name):
    """The same configuration from both packages, at float32."""
    jcfg, pcfg = get_config(name), port_config(name)
    if name == "qwen2-1.5b":
        jcfg, pcfg = reduced(jcfg), port_reduced(pcfg)
    return (dataclasses.replace(jcfg, dtype="float32"),
            dataclasses.replace(pcfg, dtype="float32"))


@functools.lru_cache(maxsize=None)
def reference(name):
    """The JAX model of ``name`` at float32 and its weights as numpy."""
    jcfg, _ = configs(name)
    jmodel = JaxModel(jcfg, attn_chunk=8, remat=False)
    init = jax.jit(jmodel.init)
    return jmodel, jax.tree_util.tree_map(np.asarray,
                                          init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("name", list_archs())
def test_port_config_copies_match_the_reference(name):
    assert dataclasses.asdict(port_config(name)) == \
        dataclasses.asdict(get_config(name))
    assert dataclasses.asdict(port_reduced(port_config(name))) == \
        dataclasses.asdict(reduced(get_config(name)))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["f32", "bf16"])
def test_bridge_round_trips_bits(dtype):
    a = np.random.default_rng(0).standard_normal((3, 5)).astype(dtype)
    t = tensor_from_numpy(a, device="cpu")
    assert t.dtype == {np.float32: torch.float32}.get(dtype, torch.bfloat16)
    back = (t.view(torch.int16).numpy().view(np.uint16) if
            t.dtype == torch.bfloat16 else t.numpy())
    np.testing.assert_array_equal(back, a.view(back.dtype))


@pytest.mark.parametrize("name", ["paper-agentic", "qwen2-1.5b"])
def test_port_init_has_the_reference_layout(name):
    jcfg, pcfg = configs(name)
    jparams = jax.eval_shape(JaxModel(jcfg).init, jax.random.PRNGKey(0))
    pparams = Model(pcfg).init(torch.Generator().manual_seed(0))
    jshapes = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
               jax.tree_util.tree_flatten_with_path(jparams)[0]}
    pshapes = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
               jax.tree_util.tree_flatten_with_path(pparams)[0]}
    assert pshapes == jshapes


def test_bridge_refuses_families_the_port_does_not_serve():
    """An ``moe`` subtree without its ``router`` is still refused, as are
    names no family has."""
    params = jax.tree_util.tree_map(np.copy, reference("paper-agentic")[1])
    params["layers"]["moe"] = params["layers"].pop("mlp")
    with pytest.raises(NotImplementedError, match="router"):
        params_from_jax(params, device="cpu")
    params["layers"]["moe"]["router"] = params["layers"]["moe"]["wu"]
    params["layers"]["conv"] = params["layers"]["ln1"]
    with pytest.raises(NotImplementedError, match="conv"):
        params_from_jax(params, device="cpu")


@pytest.mark.parametrize("name,s", [("paper-agentic", 13),
                                    ("paper-agentic", 40),
                                    ("qwen2-1.5b", 21)])
def test_prefill_logits_and_kv_match_jax(name, s):
    """paper-agentic; reduced qwen2-1.5b adds the qkv bias and tied
    embeddings."""
    jcfg, pcfg = configs(name)
    jmodel, weights = reference(name)
    jparams = jax.tree_util.tree_map(jnp.asarray, weights)
    pparams = params_from_jax(weights, device="cpu")
    if jcfg.qkv_bias:
        # the reference initializes biases to zero; make them matter
        rng = np.random.default_rng(1)
        for b in ("bq", "bk", "bv"):
            bias = rng.standard_normal(jparams["layers"]["attn"][b].shape)
            jparams["layers"]["attn"][b] = jnp.asarray(bias, jnp.float32)
            pparams["layers"]["attn"][b] = torch.from_numpy(
                bias.astype(np.float32))
    tokens = np.random.default_rng(s).integers(0, jcfg.vocab_size, (2, s))
    jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(tokens, jnp.int32),
                                     max_len=s + 3)
    plogits, pcache = Model(pcfg).prefill(pparams, torch.from_numpy(tokens),
                                          max_len=s + 3)
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    for kv in ("k", "v"):
        assert pcache[kv].shape == jcache[kv].shape
        np.testing.assert_allclose(pcache[kv].numpy(),
                                   np.asarray(jcache[kv]),
                                   rtol=TOL, atol=TOL)
