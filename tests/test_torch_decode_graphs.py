"""The fused decode step at its rung's padded static inputs.

On a card, a decode of ``b`` rows on one shard runs the CUDA graph of the
smallest rung of ``DECODE_RUNGS`` that holds it, its extra rows padding
(length 0, token 0, their slot on the scratch page past the branch
manager's pages).  On the CPU no graph is captured, but the same padded
static-buffer plan runs eagerly, so these tests hold the padding against
the eager step the engine keeps for every other batch (``_decode_rung``
returning None): the same tokens and the same bytes on every real page.
Graph replay itself runs only on the card
(``tests/test_torch_cuda_kernels.py``).  Two-layer float32 models."""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.core.errors import PoolExhausted
from repro_torch.models import Model
from repro_torch.runtime.serve_loop import DECODE_RUNGS, ServeEngine

PROMPT = [5, 17, 3, 42, 7, 11, 2, 9, 30, 4, 8, 1, 22]


def setup(name="paper-agentic", **changes):
    cfg = dataclasses.replace(reduced(get_config(name), layers=2),
                              dtype="float32", **changes)
    model = Model(cfg)
    return model, model.init(torch.Generator().manual_seed(0), device="cpu")


def engine(model_params, *, padded=True, **kw):
    model, params = model_params
    kw.setdefault("num_pages", 32)
    eng = ServeEngine(model, params, page_size=4, max_pages_per_seq=8,
                      device="cpu", **kw)
    if not padded:
        eng._decode_rung = lambda b: None     # the eager step, unpadded
    return eng


def workout(eng):
    """A fork whose children fault the shared tail page (b 3 on rung 4:
    the CoW pairs padded), a step without a fault ((scratch, scratch)
    padding), a batch across rung 4 (b 5 on rung 8), and greedy and
    sampled rows on a seeded generator."""
    sid = eng.add_request(PROMPT)
    out = eng.decode([sid])
    kids = eng.fork(sid, 3)
    out += eng.decode(kids) + eng.decode(kids)
    more = [eng.add_request([1, 2, 3, 4, 5, 6]), eng.add_request([9, 8, 7])]
    out += eng.decode(kids + more)
    out += eng.decode(kids, greedy=[True, False, True], temperature=0.8,
                      generator=torch.Generator().manual_seed(7))
    return out


def real_pages(eng):
    return sorted({p for s in eng.kv._tables for p in eng.kv._tables[s]})


def counters(eng):
    st = eng.stats()
    return (st["decode_padded_rows"], st["decode_graph_captures"],
            st["decode_graph_replays"])


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp32", "int8"])
def test_padded_decode_equals_the_eager_step(kv_dtype):
    mp = setup()
    padded = engine(mp, kv_dtype=kv_dtype)
    eager = engine(mp, kv_dtype=kv_dtype, padded=False)
    assert workout(padded) == workout(eager)
    # 1 + 1 + 3 + 1 padded rows; no graph without a card
    assert counters(padded) == (6, 0, 0)
    assert counters(eager) == (0, 0, 0)
    assert padded.cow_faults == eager.cow_faults == 3
    pages = real_pages(padded)
    assert pages == real_pages(eager)
    for a, b in zip(padded.shards, eager.shards):
        for pa, pb in zip(a.pools(), b.pools()):
            if pa is not None:
                assert torch.equal(pa[:, pages], pb[:, pages])


def test_the_scratch_page_is_never_handed_out():
    mp = setup()
    eng = engine(mp, num_pages=8)
    sh = eng.shards[0]
    assert eng.kv.num_pages == eng.stats()["pages_total"] == 8
    assert sh.k_pages.shape[1] == sh.v_pages.shape[1] == 9
    assert eng.obs.metrics.snapshot()["gauges"]["engine.kv_pool_bytes"] \
        == 2 * sh.k_pages[:, :8].nbytes
    sid = eng.add_request(PROMPT)
    eng.decode([sid])
    kids = eng.fork(sid, 3)
    eng.decode(kids)                     # b 3: a padded row on rung 4
    assert sh.k_pages[:, 8].abs().sum() > 0   # it wrote the scratch page
    with pytest.raises(PoolExhausted):
        for _ in range(8):
            eng.decode(kids)
    assert 8 not in real_pages(eng)
    assert 8 not in eng.kv._free


@pytest.mark.parametrize("case", ["moe_drops", "ref", "tp2"])
def test_engines_whose_padding_could_change_a_row_run_eagerly(case):
    """An MoE whose capacity can drop a row (a padded row would take a
    slot), the legacy path and several shards never pad a batch."""
    kw = {"ref": dict(attn_impl="ref"), "tp2": dict(tp=2)}.get(case, {})
    mp = setup("dbrx-132b", moe_capacity_factor=1.25) \
        if case == "moe_drops" else setup()
    eng = engine(mp, **kw)
    assert 3 not in DECODE_RUNGS
    workout(eng)
    assert counters(eng) == (0, 0, 0)


def test_a_dropless_moe_takes_the_padded_step():
    # reduced dbrx: 4 experts, 2 a token; capacity factor E/K drops none
    mp = setup("dbrx-132b", moe_capacity_factor=2.0)
    padded, eager = engine(mp), engine(mp, padded=False)
    assert workout(padded) == workout(eager)
    assert counters(padded) == (6, 0, 0)
