"""Port parity: the launch tooling over the port's plans (``configs/shapes``,
``launch/{mesh,op_costs,roofline,dryrun,report}``).

* ``configs/shapes``: ``SHAPES``, ``cell_applicable`` (reasons included)
  on the 10 assigned archs × 4 shapes, and ``input_specs``' shapes and
  types against the reference's ``ShapeDtypeStruct`` s for every
  applicable cell; ``model_flops_for`` equal for every cell.
* The op counter against the reference's ``analyze_hlo`` over a
  single-device compile, on the same reduced dense train, prefill and
  decode steps (the port's on ``meta``): the FLOPs within 1% once the
  terms the packages compute differently by design are taken out, each
  written out from its formula.  Attention: the reference's
  ``chunked_causal_attention`` scores every chunk against the whole
  sequence, 4·b·h·hd·s² a forward and 10 more in its checkpointed backward
  (the scores recomputed, XLA dropping the recompute's P·V that no
  gradient needs, and four products); the port's flash attention kernel
  skips the tiles above the diagonal (2·b·h·hd·s(s+1), reported by its
  wrapper) and its plain recompute backward
  (``layers.chunked_attention_vjp``) scores each chunk against the keys up
  to its end, forward and four products (6·b·h·hd·s(s+c) with chunk c).
  The loss: the port recomputes each chunk's logits in the backward
  (``layers.remat``), one more 2·b·s·d·V, where the reference keeps them.
  The decode steps attend over the whole cache in both.
* The dry run over reduced configs on meta meshes ``(2, 2)`` and ``(2, 2,
  2)``: the one-of-each trace equals a walk of every position (FLOPs,
  bytes, collective bytes by op); the bytes each position stores equal the
  reference's layout (``devices_indices_map``, each distinct shard stored
  by the first device holding it, run once in a subprocess with 8 host
  devices, as ``tests/test_torch_fsdp.py``); the record has the
  reference's keys.
* The counterpart of the reference's ``tests/test_dryrun_cell.py:16``
  (which fails on the installed JAX): full-width qwen2-1.5b ``decode_32k``
  over the 16×16 meta mesh, with that test's assertions.
* ``report.dryrun_table`` renders the same text as the reference's on the
  same records.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch

import test_distributed as ref_dist
from repro.configs import ASSIGNED_ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.configs.base import reduced as ref_reduced
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.configs.shapes import cell_applicable as ref_applicable
from repro.configs.shapes import input_specs as ref_input_specs
from repro.launch import report as ref_report
from repro.launch.hlo_costs import analyze_hlo
from repro.launch.roofline import RooflineReport as RefReport
from repro.launch.roofline import model_flops_for as ref_model_flops
from repro.models.model import Model as JaxModel
from repro.optim import adamw as ref_adamw
from repro.runtime.train_loop import build_train_step as ref_build
from repro.runtime.train_loop import init_train_state as ref_init_state
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.base import reduced
from repro_torch.configs.shapes import (
    SHAPES,
    ShapeSpec,
    cell_applicable,
    input_specs,
)
from repro_torch.launch import dryrun, report
from repro_torch.launch.mesh import make_production_mesh, meta_mesh
from repro_torch.launch.op_costs import OpCounter
from repro_torch.launch.mesh import NODE_BW, NVLINK_BW
from repro_torch.launch.roofline import link_bw, model_flops_for
from repro_torch.models import Model
from repro_torch.models.decode import decode_state_specs
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import build_train_step, init_train_state

DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}
CELLS = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES]


# ---------------------------------------------------------------------------
# shapes and model FLOPs
# ---------------------------------------------------------------------------

def test_shapes_and_applicability_are_the_reference():
    assert ASSIGNED_ARCHS == REF_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    for arch, shape in CELLS:
        assert cell_applicable(get_config(arch), SHAPES[shape]) == \
            ref_applicable(ref_config(arch), REF_SHAPES[shape]), (arch, shape)


def _flat(specs, prefix=""):
    for k, v in specs.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_specs_and_model_flops_are_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for name, shape in SHAPES.items():
        assert model_flops_for(cfg, shape, shape.kind) == \
            ref_model_flops(rcfg, REF_SHAPES[name], shape.kind)
        if not cell_applicable(cfg, shape)[0]:
            continue
        got = dict(_flat(input_specs(cfg, shape)))
        want = {k: (tuple(v.shape), DTYPES[jnp.dtype(v.dtype)])
                for k, v in _flat(ref_input_specs(rcfg, REF_SHAPES[name]))}
        assert got == want, (arch, name)


def test_links_of_the_production_mesh():
    single = dict(make_production_mesh().shape)
    assert single == {"data": 16, "model": 16}
    # a model group is 16 consecutive positions: two 8-card nodes
    assert link_bw(single, ["model"]) == NODE_BW
    assert link_bw(single, ["data"]) == NODE_BW
    assert link_bw({"data": 2, "model": 4}, ["model"]) == NVLINK_BW
    assert link_bw({"data": 4, "model": 8}, ["model"]) == NVLINK_BW
    assert link_bw({"data": 4, "model": 8}, ["data"]) == NODE_BW
    assert link_bw(single, []) == NODE_BW


# ---------------------------------------------------------------------------
# the op counter against the reference's HLO accounting
# ---------------------------------------------------------------------------

B, S, CHUNK = 2, 32, 8


def _configs():
    return (dataclasses.replace(ref_reduced(ref_config("qwen2-1.5b")),
                                dtype="float32"),
            dataclasses.replace(reduced(get_config("qwen2-1.5b")),
                                dtype="float32"))


def _own_terms(cfg, kind, package):
    """The FLOPs each package computes its own way (module docstring):
    attention over all layers, and the port's recomputed loss logits."""
    b, h, hd, s, c = B, cfg.num_heads, cfg.head_dim, S, CHUNK
    if package == "reference":
        per = {"train": 14 * b * h * hd * s * s, "prefill": 4 * b * h * hd
               * s * s, "decode": 4 * b * h * hd * s}[kind]
        return per * cfg.num_layers
    fwd = 2 * b * h * hd * s * (s + 1)
    per = {"train": fwd + 6 * b * h * hd * s * (s + c), "prefill": fwd,
           "decode": 4 * b * h * hd * s}[kind]
    loss = 2 * b * s * cfg.d_model * cfg.vocab_size if kind == "train" else 0
    return per * cfg.num_layers + loss


@pytest.fixture(scope="module")
def hlo_flops():
    """The reference's steps compiled for one CPU device, and their
    ``analyze_hlo`` FLOPs."""
    jcfg, _ = _configs()
    jm = JaxModel(jcfg, attn_chunk=CHUNK, loss_chunk=CHUNK, remat=False)
    state = jax.eval_shape(lambda: ref_init_state(jm, ref_adamw(1e-3),
                                                  jax.random.PRNGKey(0)))
    params = state.params
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    out = {}
    step = ref_build(jm, ref_adamw(1e-3))
    out["train"] = jax.jit(step).lower(state, {"tokens": tok,
                                               "targets": tok})
    out["prefill"] = jax.jit(lambda p, t: jm.prefill(p, t)).lower(params,
                                                                  tok)
    cache = jax.eval_shape(lambda: jm.init_decode_state(B, S))
    out["decode"] = jax.jit(jm.decode_step).lower(
        params, cache, jax.ShapeDtypeStruct((B, 1), jnp.int32),
        jax.ShapeDtypeStruct((B,), jnp.int32))
    return {k: analyze_hlo(v.compile().as_text()).flops
            for k, v in out.items()}


def _port_flops(kind):
    _, cfg = _configs()
    model = Model(cfg, attn_chunk=CHUNK, loss_chunk=CHUNK, remat=False)
    tok = torch.empty((B, S), dtype=torch.int32, device="meta")
    with OpCounter() as counter:
        if kind == "train":
            opt = adamw(1e-3)
            state = init_train_state(model, opt, device="meta")
            build_train_step(model, opt)(state, {"tokens": tok,
                                                 "targets": tok})
        else:
            params = model.init(device="meta")
            with torch.no_grad():
                if kind == "prefill":
                    model.prefill(params, tok)
                else:
                    cache = {k: torch.empty(s, dtype=d, device="meta")
                             for k, (s, d)
                             in decode_state_specs(cfg, B, S).items()}
                    model.decode_step(
                        params, cache,
                        torch.empty((B, 1), dtype=torch.int32, device="meta"),
                        torch.empty((B,), dtype=torch.int32, device="meta"))
    return counter.cost()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_op_counter_flops_match_the_reference_hlo(hlo_flops, kind):
    jcfg, cfg = _configs()
    cost = _port_flops(kind)
    if kind != "decode":
        assert cost.kernels["flash_attention"]["calls"] == cfg.num_layers
    got = cost.flops - _own_terms(cfg, kind, "port")
    want = hlo_flops[kind] - _own_terms(jcfg, kind, "reference")
    assert want > 0
    assert abs(got - want) <= 0.01 * want, (kind, got, want)


# ---------------------------------------------------------------------------
# the dry run on small meta meshes
# ---------------------------------------------------------------------------

SMALL_MESHES = {"2x2": ((2, 2), ("data", "model")),
                "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
SMALL_SHAPES = {"train": ShapeSpec("train_small", 32, 8, "train"),
                "prefill": ShapeSpec("prefill_small", 32, 4, "prefill"),
                "decode": ShapeSpec("decode_small", 32, 4, "decode")}
SMALL_ARCHS = ("qwen2-1.5b", "qwen3-moe-235b-a22b", "zamba2-7b")


def small_cell(arch, mesh, kind, one_of_each):
    shape, names = SMALL_MESHES[mesh]
    cfg = reduced(get_config(arch), d_model=64)
    return dryrun.run_cell(arch, SMALL_SHAPES[kind].name, mesh, None,
                           one_of_each=one_of_each, cfg=cfg,
                           mesh=meta_mesh(shape, names),
                           shape=SMALL_SHAPES[kind])


#: the walks held: every kind for the dense and MoE configs, the hybrid's
#: prefill and decode (its train walk repeats the dense one's structure at
#: four times the seconds)
WALKS = [(k, a) for k in SMALL_SHAPES for a in SMALL_ARCHS
         if (k, a) != ("train", "zamba2-7b")]


@pytest.mark.parametrize("kind, arch", WALKS)
@pytest.mark.parametrize("mesh", list(SMALL_MESHES))
def test_one_position_trace_equals_the_walk(mesh, kind, arch):
    one = small_cell(arch, mesh, kind, True)
    walk = small_cell(arch, mesh, kind, False)
    for key in ("hlo_flops", "hlo_bytes", "coll_bytes"):
        assert one[key] == pytest.approx(walk[key], rel=1e-12), key
    assert one["coll_by_op"].keys() == walk["coll_by_op"].keys()
    for op, v in walk["coll_by_op"].items():
        assert one["coll_by_op"][op] == pytest.approx(v, rel=1e-12), op
    assert one["hlo_flops"] > 0 and one["coll_bytes"] > 0


REF_LAYOUT = """
    import json
    import jax, jax.numpy as jnp
    from repro.configs import get_config, reduced
    from repro.configs.shapes import ShapeSpec
    from repro.distributed.mesh import plan_from_mesh
    from repro.distributed.sharding import param_shardings, state_shardings
    from repro.models.model import init_params, decode_state_specs
    from repro.optim import adamw

    def first_holders(tree, shardings, m):
        # bytes of each device's distinct shards, each counted on the
        # first device (mesh order) holding it
        out = [0] * m.devices.size
        for leaf, s in zip(jax.tree_util.tree_leaves(tree),
                           jax.tree_util.tree_leaves(shardings)):
            where = s.devices_indices_map(leaf.shape)
            seen = set()
            for i, dev in enumerate(m.devices.flat):
                idx = tuple((sl.start or 0, n if sl.stop is None else sl.stop)
                            for sl, n in zip(where[dev], leaf.shape))
                if idx in seen:
                    continue
                seen.add(idx)
                n = 1
                for a, b in idx:
                    n *= b - a
                out[i] += n * leaf.dtype.itemsize
        return out

    res = {}
    for shape, names in MESHES:
        m = jax.make_mesh(shape, names, devices=jax.devices()[:len(
            jax.numpy.zeros(shape).ravel())])
        pl = plan_from_mesh(m)
        for arch in ARCHS:
            cfg = reduced(get_config(arch), d_model=64)
            p = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
            o = jax.eval_shape(adamw(1e-3).init, p)
            tree = {"params": p, "opt_state": o}
            sh = {"params": param_shardings(cfg, pl, p),
                  "opt_state": param_shardings(cfg, pl, o)}
            cache = decode_state_specs(cfg, 4, 32)
            res[f"{names}|{arch}|train"] = first_holders(tree, sh, m)
            res[f"{names}|{arch}|cache"] = first_holders(
                cache, state_shardings(cfg, pl, cache), m)
    print("REF_JSON " + json.dumps(res))
"""


@pytest.fixture(scope="module")
def ref_stored():
    body = REF_LAYOUT.replace("ARCHS", repr(SMALL_ARCHS)).replace(
        "MESHES", repr(list(SMALL_MESHES.values())))
    stdout = ref_dist.run_in_subprocess(body)
    line = next(x for x in stdout.splitlines() if x.startswith("REF_JSON "))
    return json.loads(line[len("REF_JSON "):])


@pytest.mark.parametrize("mesh", list(SMALL_MESHES))
def test_stored_bytes_per_position_are_the_reference_layout(ref_stored,
                                                            mesh):
    shape, names = SMALL_MESHES[mesh]
    for arch in SMALL_ARCHS:
        cfg = reduced(get_config(arch), d_model=64)
        m = meta_mesh(shape, names)
        cell, _ = dryrun.build_cell(arch, "train_small", mesh, cfg=cfg,
                                    mesh=m, shape=SMALL_SHAPES["train"])
        got = dryrun.stored_per_position(
            {"params": cell.stored.params,
             "opt_state": cell.stored.opt_state}, m)
        assert got == ref_stored[f"{names}|{arch}|train"], arch
        cell, _ = dryrun.build_cell(arch, "decode_small", mesh, cfg=cfg,
                                    mesh=m, shape=SMALL_SHAPES["decode"])
        got = dryrun.stored_per_position(cell.stored["cache"], m)
        assert got == ref_stored[f"{names}|{arch}|cache"], arch


def _ref_record_keys():
    rep = RefReport(arch="a", shape="s", mesh="m", chips=1, hlo_flops=1.0,
                    hlo_bytes=1.0, coll_bytes=0.0, coll_by_op={},
                    model_flops=1.0, bytes_per_device=None)
    return ({"arch", "shape", "mesh", "status"} | set(rep.to_dict())
            | {"coll_counts", "xla_flops_per_device_body_once",
               "xla_bytes_per_device_body_once", "hlo_bytes_len",
               "lower_s", "compile_s"})


@pytest.fixture(scope="module")
def qwen2_decode(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    rec = dryrun.run_cell("qwen2-1.5b", "decode_32k", "single", out)
    return rec, out


def test_dryrun_cell_qwen2_decode(qwen2_decode):
    """The reference's ``tests/test_dryrun_cell.py:16``, over the port."""
    rec, out = qwen2_decode
    assert json.loads((out / "qwen2-1.5b_decode_32k_single.json"
                       ).read_text()) == rec
    assert rec["status"] == "ok"
    assert rec["counter"] == "torch_dispatch"
    assert rec["chips"] == 256
    assert rec["hlo_flops"] > 0
    assert rec["t_memory_s"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    # decode must be memory-dominated (reads all KV + params per token)
    assert rec["t_memory_s"] > rec["t_compute_s"]
    assert _ref_record_keys() <= set(rec)


def test_report_renders_as_the_reference(qwen2_decode, tmp_path):
    rec, out = qwen2_decode
    skip = dryrun.run_cell("qwen2-1.5b", "long_500k", "single", out)
    assert skip["status"] == "skip"
    rows = report.load(out)
    assert len(rows) == 2
    for mesh in ("single", "multi"):
        assert report.dryrun_table(rows, mesh) == \
            ref_report.dryrun_table(rows, mesh)
    assert "qwen2-1.5b | decode_32k" in report.roofline_table(rows)


# ---------------------------------------------------------------------------
# the kernel wrappers on meta
# ---------------------------------------------------------------------------

def test_kernel_wrappers_on_meta_report_their_cost():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import (
        paged_attention,
        paged_chunk_attention,
    )
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ssd_scan

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    b, s, h, kv, hd = 2, 64, 12, 2, 128
    q, k = meta(b, s, h, hd), meta(b, s, kv, hd)
    x, B = meta(b, s, 8, 64), meta(b, s, 128)
    qp, kp = meta(b, 3, kv, 6, hd), meta(40, 16, kv, hd)
    bt = meta(b, 5, dtype=torch.int32)
    with OpCounter() as counter:
        out = flash_attention(q, k, k)
        y, state = ssd_scan(x, meta(b, s, 8, dtype=torch.float32),
                            meta(8, dtype=torch.float32), B, B)
        o1 = paged_chunk_attention(qp, meta(b, 3, kv, hd),
                                   meta(b, 3, kv, hd), kp, kp, bt,
                                   meta(b, dtype=torch.int32),
                                   meta(40, dtype=torch.int32))
        o3 = paged_attention(qp[:, 0], kp, kp, bt,
                             meta(b, dtype=torch.int32))
    assert (out.shape, out.dtype, out.device.type) == (q.shape, q.dtype,
                                                       "meta")
    assert y.shape == x.shape and state.shape == (b, 8, 128, 64)
    assert state.dtype == torch.float32
    assert o1.shape == qp.shape and o3.shape == qp[:, 0].shape
    walked = [5 * 16] * b                 # no lengths on meta: whole tables
    want = {"flash_attention": flash_ops.cost(q, k),
            "ssd_scan": ssd_ops.cost(x, B),
            "paged_chunk_attention": paged_ops.cost(qp, kp, walked),
            "paged_attention": paged_ops.cached_cost(qp[:, 0], kp, walked)}
    got = counter.cost().kernels
    for name, (nbytes, flops) in want.items():
        assert got[name] == {"calls": 1.0, "bytes": nbytes, "flops": flops}
    assert counter.cost().flops == sum(f for _, f in want.values())
