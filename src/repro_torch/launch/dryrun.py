"""Multi-pod dry run: count every (arch × shape × mesh) cell's step on
``meta`` tensors over the production mesh.

The port's counterpart of ``repro/launch/dryrun.py``.  The JAX package
lowers and compiles each cell's step over 512 placeholder devices and
reads XLA's cost and memory analyses; the port builds the same step over
the 16×16 (or 2×16×16) production plan with every state and input a
``meta`` tensor (``Model.init(device="meta")``: shapes, no data) and runs
it once under the op counter (``launch/op_costs.py``, a dispatch mode, not
XLA).  Options are the JAX package's: ``attn_chunk=1024``,
``loss_chunk=512``, ``remat=True``; its accumulation rule (micro-batch 2
per data position, 1 for models over 5e10 parameters); ZeRO-1 gradient
shardings with a pod axis; ``param_mode`` ``"fsdp"``/``"tp"`` and
``aligned_decode``.

**One data position.**  Every data position runs the same shapes, as does
every microbatch, so :func:`run_cell` traces one of each
(``accounting.one_of_each``: the first data position's model positions and
the first microbatch, counted for all of them) and the rest of the step
(the combine, the gradients' sums, the optimizer over every block) as it
is.  That keeps a full-width cell in seconds or minutes where a walk of
256 positions on one host takes hours; ``one_of_each=False`` walks every
position (the tests hold the two equal on small meshes).

**The record** has the JAX package's keys, so one ``report`` reads both
packages' records; ``"counter": "torch_dispatch"`` says the ``hlo_*``
numbers are the op counter's.  ``bytes_per_device`` is the busiest
position's stored blocks (parameters or train state, the cache), its
inputs and outputs, plus the activations' peak live bytes the counter saw
in the traced position (over its model positions): that last term is the
counter's estimate (``activation_bytes``).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out experiments/dryrun_torch]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import accounting

DEFAULT_OUT = "experiments/dryrun_torch"


@dataclass
class Cell:
    """One cell's step over meta state: ``run()`` issues it once."""
    cfg: Any
    shape: Any
    plan: Any
    run: Callable[[], Any]
    #: what the positions store (parameters or train state, the cache)
    stored: Any
    #: the step's inputs
    inputs: Dict[str, torch.Tensor]


def _meta(spec) -> torch.Tensor:
    shape, dtype = spec
    return torch.empty(shape, dtype=dtype, device="meta")


def build_cell(arch: str, shape_name: str, mesh_kind: str,
               overrides: Optional[dict] = None, *, cfg: Any = None,
               mesh: Any = None, shape: Any = None):
    """The cell's step over the production plan on meta state (the
    counterpart of ``build_lowered``), or ``(None, reason)`` where
    ``cell_applicable`` skips it.  ``cfg``, ``mesh`` and ``shape`` replace
    the registered config, the production mesh and the preset shape (the
    tests' reduced cells)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, cell_applicable, input_specs
    from repro_torch.distributed.blocked import block, map_leaves
    from repro_torch.distributed.mesh import plan_from_mesh
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import Model
    from repro_torch.models.plan_decode import init_cache
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.runtime.train_loop import (
        build_train_step,
        init_train_state,
    )

    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        return None, reason
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    plan = plan_from_mesh(mesh)
    opts = dict(attn_chunk=1024, loss_chunk=512, remat=True)
    if overrides:
        opts.update(overrides)
    accum_override = opts.pop("accum_steps", None)
    aligned_decode = opts.pop("aligned_decode", False)
    param_mode = opts.pop("param_mode", "fsdp")
    model = Model(cfg, plan=plan, **opts)
    specs = input_specs(cfg, shape)
    if aligned_decode and "pos" in specs:
        # continuous-batching variant: one shared decode position
        specs["pos"] = ((), specs["pos"][1])
    inputs = {k: _meta(v) for k, v in specs.items() if k != "cache"}

    if shape.kind == "train":
        opt = adamw(cosine_warmup(3e-4, 2000, 100_000))
        state = init_train_state(model, opt, device="meta")
        # grad accumulation keeps per-microbatch activations ≈ 2 seqs per
        # data position (the JAX package's rule)
        b_loc = shape.global_batch // plan.dp_size
        if accum_override is not None:
            accum = accum_override
        elif cfg.param_count() > 5e10:
            accum = max(1, b_loc)        # micro-batch 1/position: giants
        else:
            accum = max(1, b_loc // 2)   # micro-batch 2/position
        grad_sh = None
        if accum > 1 and "pod" in mesh.axis_names:
            grad_sh = param_shardings(cfg, plan, model.init(device="meta"),
                                      zero1=True)
        step = build_train_step(model, opt, accum_steps=accum,
                                grad_shardings=grad_sh)
        return Cell(cfg, shape, plan, lambda: step(state, inputs), state,
                    inputs), None

    params = model.init(device="meta")
    params = map_leaves(block, params, param_shardings(
        cfg, plan, params, drop_data=(param_mode == "tp")))
    if shape.kind == "prefill":
        def prefill():
            with torch.no_grad():
                return model.prefill(params, inputs["tokens"],
                                     inputs.get("frontend_embed"))
        return Cell(cfg, shape, plan, prefill, params, inputs), None

    b, s = shape.global_batch, shape.seq_len
    cache = init_cache(cfg, plan, b, s, value=None)

    def decode():
        with torch.no_grad():
            return model.decode_step(params, cache, inputs["tokens"],
                                     inputs["pos"])
    return Cell(cfg, shape, plan, decode, {"params": params,
                                           "cache": cache}, inputs), None


def stored_per_position(tree: Any, mesh: Any) -> list:
    """Bytes stored by each mesh position (flat, row-major): each block of
    a :class:`Blocked` leaf on its owner, a plain tensor on the first."""
    from repro_torch.distributed.blocked import is_blocked, leaves

    out = [0] * math.prod(mesh.shape.values())
    for x in leaves(tree):
        if not isinstance(x, torch.Tensor) and not is_blocked(x):
            continue
        if is_blocked(x):
            for (region, owner), blk in zip(x.sharding.blocks(x.shape),
                                            x.blocks):
                out[owner] += blk.numel() * blk.element_size()
        else:
            out[0] += x.numel() * x.element_size()
    return out


def trace_cell(cell: Cell, one_of_each: bool = True):
    """Run the cell's step once under the op counter: (its cost, the
    step's output)."""
    from repro_torch.launch.op_costs import OpCounter

    each = accounting.one_of_each() if one_of_each \
        else contextlib.nullcontext()
    with OpCounter() as counter, each:
        out = cell.run()
    return counter.cost(), out


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path,
             overrides=None, tag: str = "", *, one_of_each: bool = True,
             cfg: Any = None, mesh: Any = None, shape: Any = None) -> dict:
    from repro_torch.launch.roofline import RooflineReport, model_flops_for

    t0 = time.perf_counter()
    record: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                              "mesh": mesh_kind, "status": "ok",
                              "counter": "torch_dispatch"}
    cell, skip_reason = build_cell(arch, shape_name, mesh_kind, overrides,
                                   cfg=cfg, mesh=mesh, shape=shape)
    if cell is None:
        record["status"] = "skip"
        record["reason"] = skip_reason
        _write(out_dir, f"{arch}_{shape_name}_{mesh_kind}", record)
        print(f"SKIP {arch} × {shape_name} × {mesh_kind}: {skip_reason}")
        return record
    t_build = time.perf_counter() - t0
    cost, out = trace_cell(cell, one_of_each)
    t_trace = time.perf_counter() - t0 - t_build

    mesh_obj = cell.plan.mesh
    chips = math.prod(mesh_obj.shape.values())
    tp = cell.plan.tp_size
    # a prefill's cache is stored where it is made; a step's new state
    # replaces the one it was given
    kept = out[1] if cell.shape.kind == "prefill" else None
    stored = [a + b for a, b in zip(
        stored_per_position(cell.stored, mesh_obj),
        stored_per_position(kept, mesh_obj))]
    small = out[1] if cell.shape.kind == "train" else out[0]
    io = sum(x.numel() * x.element_size() for x in
             [*cell.inputs.values(), *torch.utils._pytree.tree_leaves(small)]
             if isinstance(x, torch.Tensor))
    activation = cost.peak_live_bytes / tp
    report = RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_kind, chips=chips,
        hlo_flops=cost.flops, hlo_bytes=cost.bytes_accessed,
        coll_bytes=cost.coll_bytes, coll_by_op=dict(cost.coll_bytes_by_op),
        model_flops=model_flops_for(cell.cfg, cell.shape, cell.shape.kind),
        bytes_per_device=max(stored) + io / chips + activation,
        coll_by_axes={"/".join(k): v
                      for k, v in cost.coll_bytes_by_axes.items()},
        mesh_shape=dict(mesh_obj.shape))
    record.update(report.to_dict())
    record["coll_counts"] = {k: v / chips
                             for k, v in cost.coll_count_by_op.items()}
    record["kernels"] = cost.kernels
    record["stored_bytes_max"] = max(stored)
    record["activation_bytes"] = activation
    record["io_bytes_per_device"] = io / chips
    record["ops"] = cost.ops
    record["one_of_each"] = one_of_each
    # the keys of XLA's own analyses, which the port has not
    record["xla_flops_per_device_body_once"] = None
    record["xla_bytes_per_device_body_once"] = None
    record["hlo_bytes_len"] = None
    record["lower_s"] = round(t_build + t_trace, 1)
    record["compile_s"] = 0.0
    if tag:
        record["tag"] = tag
    name = f"{arch}_{shape_name}_{mesh_kind}" + (f"_{tag}" if tag else "")
    _write(out_dir, name, record)
    print(f"OK {arch} × {shape_name} × {mesh_kind}: "
          f"compute={report.t_compute:.4f}s memory={report.t_memory:.4f}s "
          f"collective={report.t_collective:.4f}s "
          f"bottleneck={report.bottleneck} "
          f"roofline={report.roofline_fraction:.3f} "
          f"(build {t_build:.1f}s, trace {t_trace:.1f}s)")
    return record


def _write(out_dir: Optional[Path], name: str, record: dict) -> None:
    if out_dir is None:
        return
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{name}.json").write_text(json.dumps(record, indent=2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="run every (arch × shape) cell in subprocesses")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="", help="variant tag for perf runs")
    ap.add_argument("--override", default="",
                    help="JSON dict of Model kwargs (perf experiments)")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        from repro_torch.configs import ASSIGNED_ARCHS
        from repro_torch.configs.shapes import SHAPES

        failures = []
        for arch in ASSIGNED_ARCHS:
            for shape in SHAPES:
                for mesh in meshes:
                    dest = out_dir / f"{arch}_{shape}_{mesh}.json"
                    if dest.exists():
                        print(f"cached {dest}")
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape,
                           "--mesh", mesh, "--out", str(out_dir)]
                    t = time.perf_counter()
                    r = subprocess.run(cmd)
                    print(f"wall {arch} × {shape} × {mesh}: "
                          f"{time.perf_counter() - t:.1f} s")
                    if r.returncode != 0:
                        failures.append((arch, shape, mesh))
        if failures:
            print(f"FAILED cells: {failures}")
            return 1
        print("all cells passed")
        return 0

    overrides = json.loads(args.override) if args.override else None
    try:
        for mesh in meshes:
            t = time.perf_counter()
            run_cell(args.arch, args.shape, mesh, out_dir,
                     overrides=overrides, tag=args.tag)
            print(f"wall {args.arch} × {args.shape} × {mesh}: "
                  f"{time.perf_counter() - t:.1f} s")
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
