"""Serving on four cards (skipped with fewer): what one card cannot hold or
show.

Run on a machine with four cards: ``python -m pytest -m cuda -s
tests/test_torch_cuda_four_cards.py``.  Each test prints one line of
measurements (``-s``) beside ``nvidia-smi``'s card name and power limit.

* ``dbrx-132b`` at full width and depth (40 layers, 131.6 B parameters,
  263 GB in bf16) at tp 4, one shard a card, its weights drawn shard by
  shard (``Model.init(generator, shards=plan)``), through the engine's
  whole cycle: four prompts of 512-1024 tokens (the dense prefill, K2 at h
  12 over kv 2), fork 4 each, 16 fused steps at b 16 (K1 at kv 2, g 6), a
  4x4 verify, commit and release.  Finite logits, the pool drained, K1 and
  K2 launches equal to their calls, every card's init and step peaks under
  its memory, and each card's stored weight bytes within 10% of its share
  (a quarter of the split leaves plus the replicated ones).
* At 8 of its 40 layers (about 55 GB, which one card holds): tp 4 over
  the four cards against tp 1 on cuda:0, on ``chip_smoke.py`` phase 12's
  load: the shard-drawn weights equal to the whole init's slices bit for
  bit (drawn by a generator on cuda:1: the drawing card changes no
  value), at least 99% of the first routing call's rows routed as tp 1
  routes them, the first step's logits equal to tp 4's with every shard
  on cuda:0 within 2**-7, and, at a capacity that drops no row, those of
  the rows routed as tp 1 at every routing call of the step within
  ``TP_BF16_REL_RMS`` relative RMS.
* ``python -m repro_torch.launch.serve --tp 4 --arch dbrx-132b`` as a
  subprocess.
* ``qwen2-1.5b`` served over a (data 1, model 4) plan, one model position
  a card (``Model(plan=).prefill``/``decode_step``: the cache's sequence
  blocks on four cards, the decode attention's partial softmax states
  merged across them), against the same mesh on cuda:0 alone: the first
  logits within 2**-7 relative RMS and the first greedy token identical.
"""

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.distributed import serving_mesh, serving_plan
from repro_torch.distributed.mesh import DeviceMesh, plan_from_mesh
from repro_torch.distributed.sharding import serve_specs, shard_leaf
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import Model, moe
from repro_torch.runtime import ServeEngine, serve_loop

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
#: bf16 logits of tp 4 against tp 1: each sublayer adds the shards' bf16
#: partials where tp 1 rounds one product (``chip_smoke.TP_BF16_REL_RMS``)
TP_BF16_REL_RMS = 2 ** -5
#: the full-depth cycle's prompts, and phase 12's load at 8 layers (the
#: second prompt shares the first's 512-token head)
DBRX_PROMPTS = (512, 640, 768, 1024)
PHASE12_PROMPTS = (1024, 768, 384, 128)
DRAFTS = [[1, 2, 3, 4], [4, 3, 2, 1], [7, 7, 7, 7], [9, 8, 7, 6]]


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards: one shard or position a card")
    gc.collect()
    torch.cuda.empty_cache()
    cards = [torch.device("cuda", i) for i in range(4)]
    for c in cards:    # the allocator's statistics exist once a card is used
        torch.empty(1, device=c)
    return cards


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def gb(n):
    return round(n / 1e9, 3)


def sync(devices):
    for d in devices:
        torch.cuda.synchronize(d)


def stored_bytes(trees):
    """Bytes of the distinct storages behind the trees' leaves, by device:
    a view that kept a whole draw alive would count it whole."""
    seen, out = set(), {}
    for tree in trees:
        for _, x in leaves(tree):
            st = x.untyped_storage()
            if (x.device, st.data_ptr()) not in seen:
                seen.add((x.device, st.data_ptr()))
                out[str(x.device)] = out.get(str(x.device), 0) + st.nbytes()
    return out


def share_bytes(cfg, plan):
    """A shard's bytes by the serving specs: a quarter of each split leaf
    and every replicated leaf whole."""
    like = Model(cfg).init(device="meta")
    specs = serve_specs(cfg, plan, like)
    total = 0
    for path, x in leaves(like):
        spec = specs
        for k in path:
            spec = spec[k]
        total += x.nbytes // plan.tp_size if "tp" in spec else x.nbytes
    return total


def counting(monkeypatch):
    """Count the engine's calls of K1 and K2 (the names ``serve_loop``
    bound) and keep each call's argument shapes (q, and k for K2)."""
    calls = {"paged_chunk_attention": 0, "flash_attention": 0}
    shapes = {name: set() for name in calls}
    for name in calls:
        def call(*args, _name=name, _fn=getattr(serve_loop, name), **kw):
            calls[_name] += 1
            shapes[_name].add(tuple(tuple(a.shape) for a in args[:2]))
            return _fn(*args, **kw)
        monkeypatch.setattr(serve_loop, name, call)
    return calls, shapes


def zero_launches():
    for counts in (paged_ops.LAUNCHES, flash_ops.LAUNCHES):
        for name in counts:
            counts[name] = 0


def test_dbrx_132b_serves_at_full_depth_one_shard_a_card(cards,
                                                         monkeypatch):
    cfg = get_config("dbrx-132b")
    assert cfg.num_layers == 40
    model = Model(cfg)
    plan = serving_plan(serving_mesh(4))
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    t0 = time.perf_counter()
    shards = model.init(torch.Generator(device="cuda:0").manual_seed(0),
                        shards=plan)
    sync(cards)
    init_s = time.perf_counter() - t0
    init_peak = {str(c): torch.cuda.max_memory_allocated(c) for c in cards}
    total = {str(c): torch.cuda.mem_get_info(c)[1] for c in cards}
    stored = stored_bytes(shards)
    share = share_bytes(cfg, plan)
    n_params = sum(x.numel() for _, x in leaves(model.init(device="meta")))

    calls, shapes = counting(monkeypatch)
    zero_launches()
    eng = ServeEngine(model, shards, mesh=plan.mesh, page_size=16,
                      num_pages=512, max_pages_per_seq=128)
    finite = []

    def step_logits(self, *args, _real=ServeEngine._fused_decode_step,
                    **kw):
        out = _real(self, *args, **kw)
        finite.append(torch.isfinite(out).all())
        return out
    monkeypatch.setattr(ServeEngine, "_fused_decode_step", step_logits)
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    rng = np.random.default_rng(0)
    prefill_ms, roots = [], []
    for n in DBRX_PROMPTS:
        prompt = rng.integers(0, cfg.vocab_size, n).tolist()
        sync(cards)
        t0 = time.perf_counter()
        roots.append(eng.add_request(prompt))
        sync(cards)
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    kids = {r: eng.fork(r, 4) for r in roots}
    batch = [k for r in roots for k in kids[r]]
    step_ms = []
    for _ in range(16):
        t0 = time.perf_counter()
        out = eng.decode(batch)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        assert len(out) == 16 and all(0 <= t < cfg.vocab_size for t in out)
    rows = eng.spec_verify(batch[0], DRAFTS)
    for r in roots:
        eng.commit(kids[r][0])
        eng.release(r)
    sync(cards)
    step_peak = {str(c): torch.cuda.max_memory_allocated(c) for c in cards}
    launches = {**paged_ops.LAUNCHES, **flash_ops.LAUNCHES}
    st = eng.stats()
    p50 = float(np.median(step_ms))
    print("DBRX_TP4 " + json.dumps({
        "card": card_line(), "params_b": round(n_params / 1e9, 3),
        "init_s": round(init_s, 1),
        "init_peak_gb": {k: gb(v) for k, v in init_peak.items()},
        "step_peak_gb": {k: gb(v) for k, v in step_peak.items()},
        "total_gb": {k: gb(v) for k, v in total.items()},
        "stored_gb": {k: gb(v) for k, v in stored.items()},
        "share_gb": gb(share), "prefill_ms": [round(x, 3) for x in prefill_ms],
        "decode_step_ms_p50": round(p50, 3),
        "decode_tokens_per_s": round(16 / p50 * 1e3, 1),
        "launches": launches, "calls": calls,
        "shapes": {k: sorted(v)[:3] for k, v in shapes.items()}}))
    assert abs(n_params / 1e9 - 131.6) < 0.1
    assert len(rows) == 4 and all(len(r) == 4 for r in rows)
    assert len(finite) == 16 and bool(torch.stack(finite).all())
    assert st["sequences_live"] == 0
    assert st["pages_free"] + st["prefix_pages_cached"] == st["pages_total"]
    assert calls["paged_chunk_attention"] and calls["flash_attention"]
    assert all(launches[k] == n for k, n in calls.items()), (launches, calls)
    # K1 at kv 2, g 6 (q [b, t, kv, g, hd]); K2 at h 12 over kv 2
    assert {s[0][2:] for s in shapes["paged_chunk_attention"]} == {
        (2, 6, 128)}
    assert {(s[0][2], s[1][2]) for s in shapes["flash_attention"]} == {
        (12, 2)}
    for c in map(str, cards):
        assert init_peak[c] < total[c] and step_peak[c] < total[c], c
        assert abs(stored[c] - share) <= 0.1 * share, (c, stored[c], share)


def no_drop(cfg):
    """``cfg`` at the capacity factor ``E/K``: ``C = n`` slots an expert,
    so no expert drops a row (``chip_smoke.no_drop``)."""
    return dataclasses.replace(
        cfg, moe_capacity_factor=cfg.num_experts / cfg.experts_per_token)


def phase12_first_step(model, params, monkeypatch, **engine):
    """Phase 12's load (page 16, prefix cache, the second prompt sharing
    the first's 512-token head, 4 branches each, b 16): the first fused
    step's logits on the host, the first routing call's expert ids, and
    the expert ids of every routing call inside that step (at tp 4 each
    shard routes every row: one call a shard, in shard order)."""
    cfg = model.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PHASE12_PROMPTS]
    prompts[1][:512] = prompts[0][:512]
    first, in_step, logits = [], [], []
    stepping = [False]
    real_route, real_step = moe.route, ServeEngine._fused_decode_step

    def route(*args, **kw):
        out = real_route(*args, **kw)
        if not first:
            first.append(out[2].tolist())
        if stepping[0]:
            in_step.append(out[2].tolist())
        return out

    def step(self, *args, **kw):
        stepping[0] = not logits
        out = real_step(self, *args, **kw)
        if stepping[0]:
            logits.append(out.float().cpu())
        stepping[0] = False
        return out
    monkeypatch.setattr(moe, "route", route)
    monkeypatch.setattr(ServeEngine, "_fused_decode_step", step)
    eng = ServeEngine(model, params, page_size=16, num_pages=2048,
                      max_pages_per_seq=128, prefix_cache=True, **engine)
    roots = [eng.add_request(p) for p in prompts]
    eng.decode([k for r in roots for k in eng.fork(r, 4)])
    for r in roots:
        eng.release(r)
    monkeypatch.undo()
    return logits[0], first[0], in_step


def rel_rms(got, want):
    return float((got - want).square().mean().sqrt()
                 / want.square().mean().sqrt())


def rows_routed_alike(calls, one_calls, shards):
    """For each row of a step, whether its expert ids equal tp 1's
    (``one_calls``, one call a layer) at every routing call; ``calls``
    holds ``shards`` calls a layer, which must agree."""
    layers = [calls[i:i + shards] for i in range(0, len(calls), shards)]
    assert len(layers) == len(one_calls)
    assert all(c == layer[0] for layer in layers for c in layer)
    return [all(layer[0][r] == one[r] for layer, one in zip(layers,
                                                           one_calls))
            for r in range(len(one_calls[0]))]


def test_dbrx_at_eight_layers_over_four_cards_is_tp1(cards, monkeypatch):
    """tp 4 over the four cards against tp 1 on cuda:0: the weights drawn
    shard by shard equal the whole init's slices, the first routing call's
    rows route as tp 1 routes them, tp 4 over four cards equals tp 4 with
    every shard on cuda:0 (the copies between cards change no value), and
    at a capacity that drops no row the rows routed as tp 1 at every call
    of the first step (at least half of them) have its logits within
    ``TP_BF16_REL_RMS``.  At the config's capacity the first step is
    printed: at b 16 each expert keeps 5 slots, and one row routed apart
    moves which of the others the later layers drop."""
    cfg = dataclasses.replace(get_config("dbrx-132b"), num_layers=8)
    model, loose = Model(cfg), Model(no_drop(cfg))
    whole = model.init(torch.Generator(device="cuda:0").manual_seed(0))
    one, one_ids, _ = phase12_first_step(model, whole, monkeypatch,
                                         device="cuda:0")
    one_open, _, one_calls = phase12_first_step(loose, whole, monkeypatch,
                                                device="cuda:0")
    plan = serving_plan(serving_mesh(4))
    shards = model.init(torch.Generator(device="cuda:1").manual_seed(0),
                        shards=plan)
    specs = serve_specs(cfg, plan, whole)
    equal = True
    for rank, (dev, tree) in enumerate(zip(plan.devices, shards)):
        for path, x in leaves(tree):
            spec, w = specs, whole
            for k in path:
                spec, w = spec[k], w[k]
            equal &= torch.equal(x, shard_leaf(w, spec, "tp", rank, 4, dev))
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    four, four_ids, _ = phase12_first_step(model, shards, monkeypatch,
                                           mesh=plan.mesh)
    four_open, _, four_calls = phase12_first_step(loose, shards, monkeypatch,
                                                  mesh=plan.mesh)
    peaks = {str(c): gb(torch.cuda.max_memory_allocated(c)) for c in cards}
    on0 = [tree_to(t, "cuda:0") for t in shards]
    del shards
    gc.collect()
    torch.cuda.empty_cache()
    one_card, _, _ = phase12_first_step(
        model, on0, monkeypatch, mesh=serving_mesh(4, ["cuda:0"] * 4))
    routed = sum(a == b for a, b in zip(four_ids, one_ids)) / len(one_ids)
    alike = rows_routed_alike(four_calls, one_calls, 4)
    rows = [r for r, a in enumerate(alike) if a]
    rel_alike = rel_rms(four_open[rows], one_open[rows]) if rows else 1.0

    def by_row(got, want):
        return [round(x, 4) for x in ((got - want).square().mean(-1).sqrt()
                / want.square().mean(-1).sqrt()).flatten().tolist()]
    print("DBRX_TP4_8LAYERS " + json.dumps({
        "card": card_line(), "weights_bit_equal": bool(equal),
        "first_call_rows": len(one_ids), "first_call_rows_as_tp1": routed,
        "four_cards_vs_one_card_tp4_rel_rms": rel_rms(four, one_card),
        "no_drop": {"capacity_factor": loose.cfg.moe_capacity_factor,
                    "rows_alike": len(rows), "rows": len(alike),
                    "routing_calls": len(one_calls),
                    "alike_rel_rms": rel_alike,
                    "rel_rms": rel_rms(four_open, one_open),
                    "by_row": by_row(four_open, one_open)},
        "first_step_rel_rms": rel_rms(four, one),
        "first_step_rel_rms_by_row": by_row(four, one),
        "first_step_argmax_agree": float(
            (four.argmax(-1) == one.argmax(-1)).float().mean()),
        "peak_gb": peaks}))
    assert equal
    assert routed >= 0.99
    assert rel_rms(four, one_card) <= 2 ** -7
    assert len(rows) >= len(alike) / 2
    assert rel_alike <= TP_BF16_REL_RMS


def test_launch_serve_dbrx_132b_over_four_cards(cards):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--tp", "4",
         "--arch", "dbrx-132b", "--requests", "2", "--tokens", "4",
         "--branches", "2"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=600)
    lines = proc.stdout.splitlines()
    print(f"LAUNCH_DBRX_TP4 {time.perf_counter() - t0:.1f} s, rc "
          f"{proc.returncode}:\n{proc.stdout}{proc.stderr[-3000:]}")
    assert proc.returncode == 0
    assert lines[0] == "serving mesh: tp=4 over [cuda:0, cuda:1, cuda:2, " \
        "cuda:3]"
    assert lines[1].startswith("init peak per card: cuda:0 ")
    assert sum(ln.startswith("request ") for ln in lines) == 2
    assert lines[-1].endswith("handles: 0 open")


def plan_serve(cfg, params, devices, tokens, steps):
    """``Model(plan=)`` over (data 1, model 4) of ``devices``: the prefill's
    logits and ``steps`` greedy decode steps' tokens, with the cache's
    layout."""
    mesh = DeviceMesh(np.array(devices, dtype=object).reshape(1, 4),
                      ("data", "model"))
    model = Model(cfg, plan=plan_from_mesh(mesh))
    b, s = tokens.shape
    logits, cache = model.prefill(params, tokens, max_len=s + steps)
    first = logits.float().cpu()
    toks = []
    for i in range(steps):
        tok = logits[:, -1].argmax(-1)
        toks.append(tok.tolist())
        pos = torch.full((b,), s + i, device=devices[0])
        logits, cache = model.decode_step(params, cache, tok[:, None], pos)
    k = cache["k"]
    layout = sorted({str(blk.device) for blk in k.blocks})
    return first, toks, layout


def test_qwen2_plan_serving_one_position_a_card(cards):
    cfg = get_config("qwen2-1.5b")
    params = Model(cfg).init(torch.Generator(device="cuda:0").manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 4096))
                              ).to("cuda:0")
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    t0 = time.perf_counter()
    got = plan_serve(cfg, params, cards, tokens, 8)
    sync(cards)
    secs = time.perf_counter() - t0
    peaks = {str(c): gb(torch.cuda.max_memory_allocated(c)) for c in cards}
    want = plan_serve(cfg, params, ["cuda:0"] * 4, tokens, 8)
    rel = float((got[0] - want[0]).square().mean().sqrt()
                / want[0].square().mean().sqrt())
    print("QWEN2_PLAN_4CARD " + json.dumps({
        "card": card_line(), "first_logits_rel_rms": rel,
        "tokens_agree": float(np.mean(np.array(got[1]) == np.array(want[1]))),
        "cache_blocks_on": got[2], "seconds": round(secs, 1),
        "peak_gb": peaks}))
    assert got[2] == [str(c) for c in cards]
    assert rel <= 2 ** -7
    assert got[1][0] == want[1][0]
