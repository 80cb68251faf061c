"""Port parity: the dense, VLM-stub and audio families through ``Model``.

``granite-8b``, ``nemotron-4-15b`` (squared-ReLU MLP, no gate),
``stablelm-12b``, ``pixtral-12b`` (VLM stub: precomputed patch embeddings
over the prompt's first positions) and ``musicgen-medium`` (four parallel
codebooks, geglu) at ``reduced()`` widths in float32.  Both packages run
from one set of weights: the JAX package's ``Model.init(PRNGKey(0))``,
leaf by leaf through numpy into ``params_from_jax``.  The prefill's
last-position logits and K/V, and four ``decode_step``s over the
contiguous cache (scalar and ``[b]`` positions, the two forms of the
reference's ``attention_decode_block``), must agree within 1e-4: float32
on both sides, with summation orders that differ between XLA and PyTorch.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.configs import get_config
from repro.configs.base import reduced
from repro.models import layers as jax_layers
from repro.models.model import Model as JaxModel
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import ArchConfig as PortArchConfig
from repro_torch.configs.base import reduced as port_reduced
from repro_torch.models import Model
from repro_torch.models import layers as port_layers
from repro_torch.models import transformer as port_transformer

TOL = 1e-4
NAMES = ["granite-8b", "nemotron-4-15b", "stablelm-12b", "pixtral-12b",
         "musicgen-medium"]
#: ArchConfig.param_count() in billions and KV bytes per token (bf16, KiB)
#: of the full configs
SIZES = {"granite-8b": (8.25, 144), "nemotron-4-15b": (15.63, 128),
         "stablelm-12b": (12.14, 200), "pixtral-12b": (12.27, 160),
         "musicgen-medium": (1.84, 288)}


def configs(name):
    """The reduced configuration from both packages, at float32."""
    return (dataclasses.replace(reduced(get_config(name)), dtype="float32"),
            dataclasses.replace(port_reduced(port_config(name)),
                                dtype="float32"))


@functools.lru_cache(maxsize=None)
def reference(name):
    """The JAX model of ``name`` at float32 and its weights as numpy."""
    jcfg, _ = configs(name)
    jmodel = JaxModel(jcfg, attn_chunk=8, remat=False)
    init = jax.jit(jmodel.init)
    return jmodel, jax.tree_util.tree_map(np.asarray,
                                          init(jax.random.PRNGKey(0)))


def shapes(tree):
    return {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def token_array(cfg, rng, b, s):
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks > 1 else (b, s)
    return rng.integers(0, cfg.vocab_size, shape)


@pytest.mark.parametrize("name", NAMES)
def test_config_copy_and_sizes(name):
    full = port_config(name)
    assert dataclasses.asdict(full) == dataclasses.asdict(get_config(name))
    assert full.param_count() == get_config(name).param_count()
    billions, kib = SIZES[name]
    assert round(full.param_count() / 1e9, 2) == billions
    assert full.kv_bytes_per_token() == kib * 1024
    assert dataclasses.asdict(port_reduced(full)) == \
        dataclasses.asdict(reduced(get_config(name)))


@pytest.mark.parametrize("name", NAMES)
def test_port_init_has_the_reference_layout(name):
    jcfg, pcfg = configs(name)
    jparams = jax.eval_shape(JaxModel(jcfg).init, jax.random.PRNGKey(0))
    pparams = Model(pcfg).init(torch.Generator().manual_seed(0))
    assert shapes(pparams) == shapes(jparams)


@pytest.mark.parametrize("name", NAMES)
def test_bridge_takes_the_reference_tree(name):
    _, pcfg = configs(name)
    pparams = params_from_jax(reference(name)[1], device="cpu")
    assert shapes(pparams) == shapes(reference(name)[1])
    assert all(v.dtype == torch.float32
               for v in jax.tree_util.tree_leaves(pparams))
    if pcfg.mlp_activation == "sqrelu":
        assert "wg" not in pparams["layers"]["mlp"]


@pytest.mark.parametrize("pos_form", ["vector", "scalar"])
@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_jax(name, pos_form):
    """Prefill (pixtral with a ``frontend_embed`` prefix), then four decode
    steps with ``[b]`` or scalar positions: logits every step, and the
    caches after the last."""
    jcfg, pcfg = configs(name)
    jmodel, weights = reference(name)
    jparams = jax.tree_util.tree_map(jnp.asarray, weights)
    pparams = params_from_jax(weights, device="cpu")
    pmodel = Model(pcfg)
    rng = np.random.default_rng(len(name))
    b, s, steps = 2, 9, 4
    tokens = token_array(jcfg, rng, b, s)
    jfe = pfe = None
    if jcfg.frontend == "vlm_stub":
        fe = rng.standard_normal((b, jcfg.frontend_tokens, jcfg.d_model))
        jfe = jnp.asarray(fe, jnp.float32)
        pfe = torch.from_numpy(fe.astype(np.float32))
    jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(tokens, jnp.int32),
                                     jfe, max_len=s + steps)
    plogits, pcache = pmodel.prefill(pparams, torch.from_numpy(tokens), pfe,
                                     max_len=s + steps)
    assert tuple(plogits.shape) == tuple(jlogits.shape)
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    for kv in ("k", "v"):
        np.testing.assert_allclose(pcache[kv].numpy(), np.asarray(jcache[kv]),
                                   rtol=TOL, atol=TOL)
    for t in range(s, s + steps):
        tok = token_array(jcfg, rng, b, 1)
        if pos_form == "scalar":
            jpos, ppos = jnp.int32(t), torch.tensor(t, dtype=torch.int32)
        else:
            jpos = jnp.full((b,), t, jnp.int32)
            ppos = torch.full((b,), t, dtype=torch.int32)
        jlogits, jcache = jmodel.decode_step(
            jparams, jcache, jnp.asarray(tok, jnp.int32), jpos)
        plogits, pcache = pmodel.decode_step(pparams, pcache,
                                             torch.from_numpy(tok), ppos)
        assert tuple(plogits.shape) == tuple(jlogits.shape)
        np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits),
                                   rtol=TOL, atol=TOL, err_msg=f"t={t}")
    for kv in ("k", "v"):
        np.testing.assert_allclose(pcache[kv].numpy(), np.asarray(jcache[kv]),
                                   rtol=TOL, atol=TOL)


def test_decode_writes_the_cache_it_is_given():
    _, pcfg = configs("granite-8b")
    pparams = params_from_jax(reference("granite-8b")[1], device="cpu")
    model = Model(pcfg)
    _, cache = model.prefill(pparams, torch.arange(6)[None].repeat(2, 1),
                             max_len=8)
    k, v = cache["k"], cache["v"]
    _, out = model.decode_step(pparams, cache, torch.ones(2, 1).long(),
                               torch.tensor(6))
    assert out["k"] is k and out["v"] is v
    assert k[:, :, 6].abs().sum() > 0 and not k[:, :, 7].any()


def test_musicgen_codebooks_in_and_out():
    jcfg, pcfg = configs("musicgen-medium")
    weights = reference("musicgen-medium")[1]
    pparams = params_from_jax(weights, device="cpu")
    cb, V, d = pcfg.num_codebooks, pcfg.vocab_size, pcfg.d_model
    assert tuple(pparams["embed"].shape) == (cb, V, d)
    assert tuple(pparams["lm_head"].shape) == (d, cb * V)
    model = Model(pcfg)
    tokens = token_array(pcfg, np.random.default_rng(0), 3, 5)
    logits, cache = model.prefill(pparams, torch.from_numpy(tokens))
    assert tuple(logits.shape) == (3, 1, cb, V)
    # codebook-major columns: logits[..., c, v] is column c * V + v
    h = torch.randn(3, 1, d)
    flat = h @ pparams["lm_head"]
    heads = port_transformer.lm_head(pcfg, pparams, h)
    torch.testing.assert_close(heads[:, :, 2, 7], flat[:, :, 2 * V + 7])
    # the embedding sums one row of each codebook's table, in order
    e = port_transformer.embed_tokens(pcfg, pparams,
                                      torch.from_numpy(tokens[:1, :1]))
    want = sum(pparams["embed"][c][int(tokens[0, 0, c])] for c in range(cb))
    torch.testing.assert_close(e[0, 0], want)
    logits, _ = model.decode_step(pparams, cache,
                                  torch.from_numpy(tokens[:, :1]),
                                  torch.tensor(4))
    assert tuple(logits.shape) == (3, 1, cb, V)


def test_pixtral_prefix_is_projected_and_text_alone_matches_jax():
    jcfg, pcfg = configs("pixtral-12b")
    jmodel, weights = reference("pixtral-12b")
    pparams = params_from_jax(weights, device="cpu")
    tokens = token_array(pcfg, np.random.default_rng(1), 2, 7)
    fe = torch.randn(2, pcfg.frontend_tokens, pcfg.d_model)
    h = port_transformer.embed_tokens(pcfg, pparams,
                                      torch.from_numpy(tokens), fe)
    n = pcfg.frontend_tokens
    torch.testing.assert_close(h[:, :n], fe @ pparams["frontend_proj"])
    torch.testing.assert_close(h[:, n:], pparams["embed"][tokens[:, n:]])
    # text only, as the paged engine serves it
    jlogits, _ = jmodel.prefill(jax.tree_util.tree_map(jnp.asarray, weights),
                                jnp.asarray(tokens, jnp.int32))
    plogits, _ = Model(pcfg).prefill(pparams, torch.from_numpy(tokens))
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="frontend_embed"):
        port_transformer.embed_tokens(pcfg, pparams,
                                      torch.from_numpy(tokens[:, :2]), fe)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "sqrelu"])
def test_mlp_variants_match_jax(act):
    """geglu is gelu's tanh form (``jax.nn.gelu``'s default, not
    ``torch.nn.functional.gelu``'s); the erf form misses the tolerance."""
    cfg = PortArchConfig(name="m", family="dense", num_layers=1, d_model=32,
                         num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=8,
                         mlp_activation=act, dtype="float32")
    p = port_layers.init_mlp(cfg, torch.Generator().manual_seed(0),
                             torch.float32)
    assert ("wg" in p) == (act != "sqrelu")
    x = torch.from_numpy(
        3 * np.random.default_rng(0).standard_normal((2, 5, 32), np.float32))
    want = np.asarray(jax_layers.mlp_block(
        cfg, {k: jnp.asarray(v.numpy()) for k, v in p.items()},
        jnp.asarray(x.numpy())))
    np.testing.assert_allclose(port_layers.mlp_block(cfg, p, x).numpy(),
                               want, rtol=TOL, atol=TOL)
    if act == "geglu":
        erf = (torch.nn.functional.gelu(x @ p["wg"]) * (x @ p["wu"])) \
            @ p["wd"]
        assert np.abs(erf.numpy() - want).max() > 10 * TOL


class LiveBytes(TorchDispatchMode):
    """The most bytes of tensor storage alive at once while the mode is on
    (storages created inside it, checked at every op)."""

    def __init__(self):
        super().__init__()
        self.live = {}
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for ptr in [p for p, (ref, _) in self.live.items() if ref.expired()]:
            del self.live[ptr]
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st.data_ptr() not in self.live:
                    self.live[st.data_ptr()] = (StorageWeakRef(st),
                                                st.nbytes())
        self.peak = max(self.peak, sum(n for _, n in self.live.values()))
        return out


def test_init_allocates_each_stacked_leaf_once():
    """The init's peak is the model plus one layer's draw: the stacked
    ``[L, ...]`` leaves are filled layer by layer, never stacked from a
    second full copy (which would peak at twice the layers)."""
    cfg = dataclasses.replace(
        port_reduced(port_config("nemotron-4-15b"), layers=8),
        dtype="float32")
    with LiveBytes() as mode:
        params = Model(cfg).init(torch.Generator().manual_seed(0))
    nbytes = sum(v.nbytes for v in jax.tree_util.tree_leaves(params))
    layer = sum(v[0].nbytes for v in
                jax.tree_util.tree_leaves(params["layers"]))
    assert mode.peak >= nbytes
    assert mode.peak <= nbytes + layer + 4096 <= 1.2 * nbytes, \
        (mode.peak, nbytes, layer)


@pytest.mark.parametrize("name", NAMES)
def test_decode_state_specs_match_the_reference(name, monkeypatch):
    jcfg, pcfg = configs(name)
    jstate = JaxModel(jcfg).init_decode_state(3, 10)
    pstate = Model(pcfg).init_decode_state(3, 10, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in pstate.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in jstate.items()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):   # no silent CPU
        Model(pcfg).init_decode_state(3, 10)


def test_moe_and_hybrid_stay_refused_naming_their_roadmap_items():
    """No longer refused: both packages build and bridge the MoE and the
    hybrid families (their parity is held by tests/test_torch_moe.py and
    tests/test_torch_hybrid.py)."""
    for name, family in (("dbrx-132b", "moe"), ("zamba2-7b", "hybrid")):
        jcfg = dataclasses.replace(reduced(get_config(name)),
                                   dtype="float32")
        pcfg = PortArchConfig(**dataclasses.asdict(jcfg))
        assert pcfg.family == family
        pparams = Model(pcfg).init(torch.Generator().manual_seed(0))
        weights = jax.tree_util.tree_map(
            np.asarray, jax.jit(JaxModel(jcfg).init)(jax.random.PRNGKey(0)))
        bridged = params_from_jax(weights, device="cpu")
        assert shapes(bridged) == shapes(weights) == shapes(pparams)
