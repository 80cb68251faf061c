"""The harness over tensor-parallel shards, on the CPU: the tp 1 draw as it
was, the shard-by-shard draw, the plain reference over blocks, and the
rehearsal cell served over tp 2 (both shards on the CPU)."""

import hashlib
import json
import time

import pytest
import torch

from benchlib import files, harness
from benchlib import weights as W

REHEARSAL = files.BENCH_DIR / "rehearsal.json"
TP2 = "paper-agentic-tp2.agent-tiny"
#: sha256 of paper-agentic's tp 1 draw from seed 2**31 + 12345 (each leaf's
#: path, shape and bits in tree order), as the draw gave it before it could
#: cut leaves over shards
TP1_DIGEST = ("899fdd8113d2c1e7087091ac5ef4d787"
              "90b629e1f1a6cb3b489eb3cb8520bc97")
TINY = {"name": "tiny", "family": "dense", "num_layers": 2, "d_model": 64,
        "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
        "vocab_size": 98, "rope_theta": 500000.0, "norm_eps": 1e-5,
        "mlp_activation": "swiglu", "qkv_bias": True,
        "tie_embeddings": False, "dtype": "float32"}
CASES = {
    "dense": {},
    "experts": dict(family="moe", num_experts=8, experts_per_token=2,
                    moe_capacity_factor=4.0, qkv_bias=False),
}


def _like(model):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.model import Model

    return Model(ArchConfig(**model)).init(device="meta")


def _axes(model, tp):
    """The meta tree, each leaf's split axis at ``tp`` (the serving specs)
    and the shards' devices (all the CPU)."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.distributed.mesh import serving_plan, tp_mesh
    from repro_torch.distributed.sharding import (serve_specs,
                                                  tree_map_with_path)

    like = _like(model)
    plan = serving_plan(tp_mesh(tp, "cpu"))
    specs = serve_specs(ArchConfig(**model), plan, like)
    axes = tree_map_with_path(
        lambda _, s: s.index(plan.tp_axis) if plan.tp_axis in s else None,
        specs)
    return like, axes, plan.devices


def _assemble(tree):
    """A tree of :class:`benchlib.weights.Blocks` as whole leaves."""
    if isinstance(tree, dict):
        return {k: _assemble(v) for k, v in tree.items()}
    if tree.axis is None:
        return tree.parts[0]
    return torch.cat(tree.parts, dim=tree.axis)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    else:
        yield path, tree


def test_the_tp1_draw_is_unchanged():
    model = files.load_json(files.BENCH_DIR / "configs"
                            / "paper-agentic.json")["model"]
    tree = W.draw(_like(model), 2 ** 31 + 12345, "cpu")
    h = hashlib.sha256()
    for path, x in _leaves(tree):
        h.update(path.encode())
        h.update(str(tuple(x.shape)).encode())
        h.update(x.view(torch.int16).numpy().tobytes())
    assert h.hexdigest() == TP1_DIGEST


def test_tp2_blocks_put_together_have_the_whole_shapes():
    model = files.load_json(files.BENCH_DIR / "configs"
                            / "paper-agentic-tp2.json")["model"]
    like, axes, devices = _axes(model, 2)
    blocks = W.draw_shards(like, axes, devices, 2 ** 31 + 7)
    whole = _assemble(blocks)
    split = 0
    for (path, meta), (_, b), (_, x) in zip(_leaves(like), _leaves(blocks),
                                            _leaves(whole)):
        assert x.shape == meta.shape and x.dtype == meta.dtype, path
        assert len(b.parts) == 2
        if b.axis is None:
            assert torch.equal(b.parts[0], b.parts[1]), path
            continue
        split += 1
        assert b.parts[0].shape[b.axis] == meta.shape[b.axis] // 2
        name = path.split(".")[-1]
        std = 1 / W.fan_in(name, tuple(meta.shape)) ** 0.5
        for p in b.parts:
            assert float(p.float().std()) == pytest.approx(std, rel=0.03), \
                path
    assert split >= 7       # q, k, v, o, the MLP's three, the head
    # the same seed draws the same blocks
    again = W.draw_shards(like, axes, devices, 2 ** 31 + 7)
    assert all(torch.equal(p, q) for (_, a), (_, b) in zip(
        _leaves(blocks), _leaves(again)) for p, q in zip(a.parts, b.parts))


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_shard_reference_follows_the_whole_one(case):
    model = dict(TINY, **CASES[case])
    like, axes, devices = _axes(model, 2)
    blocks = W.draw_shards(like, axes, devices, 11)
    seqs = [list(range(5, 45)), list(range(30, 52))]
    whole = files.reference_module({"reference": "decoder"}).score(
        model, _assemble(blocks), seqs, [3, 5])
    torch.backends.cuda.matmul.allow_tf32 = True
    shards = files.reference_module({"reference": "decoder_shards"})
    got = shards.score(model, blocks, seqs, [3, 5])
    assert torch.backends.cuda.matmul.allow_tf32 is False
    for a, b in zip(whole, got):
        assert b.dtype == torch.float32 and a.shape == b.shape
        assert torch.allclose(a, b, rtol=0, atol=1e-5), (a - b).abs().max()


def _run(cell, manifest=REHEARSAL, seed=3):
    args = harness.parse(["--workload", cell, "--seed", str(seed),
                          "--seconds", "2", "--trace", "0", "--device",
                          "cpu", "--manifest", str(manifest)])
    return harness.run(args, time.perf_counter_ns())


def test_a_tp2_rehearsal_run_is_correct():
    r = _run(TP2)
    assert r["correct"], r["checks"]
    assert r["checks"]["greedy_tokens"]["value"] >= 8


def test_fewer_chips_than_shards_print_no_result(tmp_path, capsys):
    manifest = tmp_path / "BENCHMARK.json"
    man = files.load_json(REHEARSAL)
    man["configs"] = [{"name": "paper-agentic-tp2", "file": str(
        files.BENCH_DIR / "configs" / "paper-agentic-tp2.json")}]
    man["workloads"] = [{"name": TP2, "config": "paper-agentic-tp2",
                         "traffic": "agent-tiny", "chips": 1}]
    manifest.write_text(json.dumps(man))
    code = harness.main(["--workload", TP2, "--seed", "3", "--seconds", "1",
                         "--trace", "0", "--device", "cpu", "--manifest",
                         str(manifest)], time.perf_counter_ns())
    out = capsys.readouterr()
    assert code != 0 and out.out == ""
    assert "tp 2" in out.err


def test_the_pool_is_sized_a_card():
    from repro_torch.configs.base import ArchConfig

    from benchlib.cell import kv_pool_pages

    def pages(name):
        cfg = files.load_json(files.BENCH_DIR / "configs" / f"{name}.json")
        return kv_pool_pages(ArchConfig(**cfg["model"]), cfg["serve"])

    # one stage on one card: 8 layers x 8 kv heads x 128 x K and V x 2 B
    assert pages("dbrx-132b-stage8") == 4_000_000_000 // (16 * 8 * 8 * 128
                                                          * 2 * 2)
    # the whole model over tp 4: a card's 4 GB holds 2 of the 8 kv heads of
    # all 40 layers (40 KiB a token)
    assert pages("dbrx-132b-tp4") == 4_000_000_000 // (16 * 40 * 2 * 128
                                                       * 2 * 2) == 6103
    # paper-agentic over tp 2 holds as many tokens as on one card
    assert pages("paper-agentic-tp2") == pages("paper-agentic")
