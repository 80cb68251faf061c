"""Port parity: the paged ServeEngine on the new dense and VLM configs.

``granite-8b``, ``nemotron-4-15b`` (squared ReLU), ``stablelm-12b`` and
``pixtral-12b`` (text only: the engine takes no image, in either package)
at ``reduced()`` widths in float32, both engines from one set of weights
(the JAX package's ``Model.init(PRNGKey(0))`` through numpy and
``params_from_jax``).  The port runs on the CPU (its kernels' plain
versions); the JAX engine runs ``attn_impl="fused_ref"`` (the fused step
with the chunk kernel's jnp oracle) or ``"ref"``.  Greedy tokens, the CoW
counters and ``spec_verify`` rows must be identical.  ``musicgen-medium``
(four codebooks) is refused by both engines: the JAX engine fails inside
its step, the port's refuses it at construction.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

import repro.runtime.serve_loop as jax_serve
from repro.configs import get_config
from repro.configs.base import reduced
from repro.models.model import Model as JaxModel
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import reduced as port_reduced
from repro_torch.models import Model
from repro_torch.runtime import ServeEngine
from torch_parity import shared_stats

NAMES = ["granite-8b", "nemotron-4-15b", "stablelm-12b", "pixtral-12b"]
PROMPT = (5, 17, 3, 42, 7, 11, 2, 9, 30, 4, 8, 1, 22)


@functools.lru_cache(maxsize=None)
def setup(name):
    jcfg = dataclasses.replace(reduced(get_config(name)), dtype="float32")
    pcfg = dataclasses.replace(port_reduced(port_config(name)),
                               dtype="float32")
    jmodel = JaxModel(jcfg, attn_chunk=8, remat=False)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    pparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jmodel, jparams, Model(pcfg), pparams


def engines(name, *, legacy=False, **kw):
    jmodel, jparams, pmodel, pparams = setup(name)
    kw.update(num_pages=128, page_size=4, max_pages_per_seq=16)
    return (jax_serve.ServeEngine(
                jmodel, jparams, attn_impl="ref" if legacy else "fused_ref",
                **kw),
            ServeEngine(pmodel, pparams, device="cpu",
                        attn_impl="ref" if legacy else "auto", **kw))


def exercise(eng):
    """Decode, a lazy-CoW fork of the partial tail page, three batched
    steps, commit, four more steps of the winner, release."""
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
    return shared_stats(eng, st)


@pytest.mark.parametrize("path", ["fused", "ref", "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_greedy_tokens_and_counters_identical(name, path):
    kw = {"kv_dtype": "int8"} if path == "int8" else {}
    jeng, peng = engines(name, legacy=path == "ref", **kw)
    assert exercise(peng) == exercise(jeng)
    assert peng.cow_faults == jeng.cow_faults > 0
    if path == "ref":
        assert peng.cow_dispatches == jeng.cow_dispatches > 0
    else:
        assert peng.cow_inline_steps == jeng.cow_inline_steps > 0
    assert counters(peng) == counters(jeng)
    assert peng.stats()["pages_free"] == peng.stats()["pages_total"]


@pytest.mark.parametrize("name", NAMES)
def test_spec_verify_rows_identical(name):
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


def test_musicgen_is_refused_by_both_engines():
    jcfg = dataclasses.replace(reduced(get_config("musicgen-medium")),
                               dtype="float32")
    pcfg = dataclasses.replace(port_reduced(port_config("musicgen-medium")),
                               dtype="float32")
    jmodel = JaxModel(jcfg, attn_chunk=8, remat=False)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    jeng = jax_serve.ServeEngine(jmodel, jparams, attn_impl="fused_ref",
                                 num_pages=64, page_size=4,
                                 max_pages_per_seq=16)
    with pytest.raises(ValueError):
        jeng.decode([jeng.add_request(list(PROMPT))])
    pparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    with pytest.raises(NotImplementedError, match="codebooks"):
        ServeEngine(Model(pcfg), pparams, device="cpu")


def test_serve_cli_takes_the_new_names(capsys):
    """``--arch`` reaches the new configs through ``get_config`` (reduced
    on the CPU, as the JAX demo does); musicgen exits 2 with the engine's
    refusal."""
    from repro_torch.launch import serve as port_cli

    assert port_cli.main(["--arch", "musicgen-medium", "--device",
                          "cpu"]) == 2
    assert "codebooks" in capsys.readouterr().err
    assert port_cli.main(["--arch", "nemotron-4-15b", "--device", "cpu",
                          "--tokens", "2", "--requests", "1",
                          "--branches", "2"]) == 0
    out = capsys.readouterr().out
    assert "request 0" in out and "handles: 0 open" in out
