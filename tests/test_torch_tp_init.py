"""Port parity: weights drawn shard by shard, and a tensor-parallel engine
given its shards already placed, on the CPU.

``Model.init(generator, shards=plan)`` draws every layer from the same
generator in the same order as the whole init and cuts each leaf into the
serving plan's tp shards as it is drawn (``distributed.sharding.
ShardDraw``), so a model no one device holds can be served.  Its trees
must equal ``shard_params`` of the whole init bit for bit: for the dense
and MoE families at tp 2 and 4, including kv-head counts that do not
divide tp (``serve_loop.kv_split``: the attention leaves then stay
whole).  ``ServeEngine(model, [tree per shard], tp=)`` takes such trees
as they are, as the JAX engine's ``device_put`` takes placed arrays
(``tests/test_torch_tp.py::test_placed_shards_serve_as_the_whole_tree``
serves them against the whole tree and the reference's single device); a
shard tree of the wrong shape, type, length or device is refused.
``launch.serve --tp 2 --device cpu`` draws its weights shard by shard and
prints the continuations it printed when it cut the whole tree.
"""

import dataclasses

import pytest
import torch

from repro.configs import get_config
from repro.configs.base import reduced
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import reduced as port_reduced
from repro_torch.distributed import serving_mesh, serving_plan, shard_params
from repro_torch.distributed.sharding import serve_specs
from repro_torch.launch import serve as port_cli
from repro_torch.models import Model
from repro_torch.runtime import ServeEngine
from repro_torch.runtime.serve_loop import kv_split

GEOMETRY = dict(num_pages=64, page_size=4, max_pages_per_seq=16)
#: the configs at float32: (registered name, reduced, field changes)
CONFIGS = {
    "paper-agentic": ("paper-agentic", False, dict(num_layers=2)),
    "qwen2": ("qwen2-1.5b", True, dict(num_kv_heads=2)),
    "dbrx": ("dbrx-132b", True, dict(num_kv_heads=2)),
    "dbrx-kv1": ("dbrx-132b", True, {}),
}


def configs(key):
    name, cut, kw = CONFIGS[key]
    kw = {"dtype": "float32", **kw}
    jcfg, pcfg = get_config(name), port_config(name)
    if cut:
        jcfg, pcfg = reduced(jcfg), port_reduced(pcfg)
    return (dataclasses.replace(jcfg, **kw),
            dataclasses.replace(pcfg, **kw))


def cpu_plan(tp):
    return serving_plan(serving_mesh(tp, ["cpu"] * tp))


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("key", ["paper-agentic", "qwen2", "dbrx",
                                 "dbrx-kv1"])
def test_shard_draw_equals_shard_params_of_the_whole_init(key, tp):
    """Bit for bit, leaf by leaf; where kv heads do not divide tp the
    attention leaves stay whole on every shard.  A shard that is a part
    of its leaf owns only its part (a view would keep the whole draw)."""
    _, cfg = configs(key)
    model, plan = Model(cfg), cpu_plan(tp)
    whole = model.init(torch.Generator().manual_seed(3))
    want = shard_params(cfg, plan, whole, serve_specs(cfg, plan, whole))
    got = model.init(torch.Generator().manual_seed(3), shards=plan)
    assert len(got) == tp
    split = kv_split(cfg, tp)
    assert split == (cfg.num_kv_heads % tp == 0)
    assert split or key != "paper-agentic"
    whole_leaves = dict(leaves(whole))
    for w, g in zip(want, got):
        wl, gl = dict(leaves(w)), dict(leaves(g))
        assert wl.keys() == gl.keys() == whole_leaves.keys()
        for path, x in gl.items():
            assert x.dtype == wl[path].dtype and torch.equal(x, wl[path]), \
                path
            if x.shape != whole_leaves[path].shape:
                assert x.untyped_storage().nbytes() == x.nbytes, path
        assert (gl[("layers", "attn", "wk")].shape
                == wl[("layers", "attn", "wk")].shape)
    wk = dict(leaves(got[0]))[("layers", "attn", "wk")]
    assert wk.shape[2] == cfg.num_kv_heads // (tp if split else 1)


@pytest.fixture(scope="module", params=["paper-agentic", "dbrx"])
def served(request):
    """A config and the port's seeded weights drawn shard by shard at tp
    2."""
    _, cfg = configs(request.param)
    model = Model(cfg)
    return model, model.init(torch.Generator().manual_seed(0),
                             shards=cpu_plan(2))


def test_the_engine_refuses_misplaced_shards(served):
    """A leaf of another shape, type or device, a missing leaf, a wrong
    count of trees, and trees without tp= are refused before any pool is
    made; nothing is moved or cut to fit."""
    model, shards = served

    def with_leaf(path, value):
        trees = [dict(t) for t in shards]
        node = trees[1]
        for k in path[:-1]:
            node[k] = dict(node[k])
            node = node[k]
        if value is None:
            del node[path[-1]]
        else:
            node[path[-1]] = value
        return trees

    wq = shards[1]["layers"]["attn"]["wq"]
    cases = {
        "shape": (with_leaf(("layers", "attn", "wq"), torch.cat([wq, wq], 2)),
                  "wq is"),
        "dtype": (with_leaf(("final_norm",),
                            shards[1]["final_norm"].double()), "final_norm"),
        "device": (with_leaf(("embed",), shards[1]["embed"].to("meta")),
                   "on meta"),
        "missing": (with_leaf(("lm_head",) if "lm_head" in shards[1]
                              else ("embed",), None), "no leaf"),
        "count": (shards[:1], "1 shard trees for tp=2"),
    }
    for name, (trees, match) in cases.items():
        with pytest.raises(ValueError, match=match):
            ServeEngine(model, trees, tp=2, device="cpu", **GEOMETRY)
    with pytest.raises(ValueError, match="needs tp= or mesh="):
        ServeEngine(model, shards, device="cpu", **GEOMETRY)


def test_launch_serve_tp2_prints_the_continuations_of_the_whole_tree(
        capsys):
    """``--device cpu --tp 2`` (shard-drawn weights) prints the lines the
    launcher printed when it drew the whole tree and cut it."""
    rc = port_cli.main(["--device", "cpu", "--tp", "2", "--tokens", "4",
                        "--requests", "2", "--branches", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert lines[:3] == [
        "serving mesh: tp=2 over [cpu, cpu]",
        "request 0: prompt [435, 326, 262, 138, 158, 21] -> "
        "[432, 70, 419, 383] (best of 2, scores ['314.5', '326.0'])",
        "request 1: prompt [242, 262, 386, 486, 18, 74] -> "
        "[240, 107, 129, 113] (best of 2, scores ['147.2', '144.5'])"]
    assert lines[-1].endswith("handles: 0 open")
