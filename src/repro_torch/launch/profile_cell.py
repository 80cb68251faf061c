"""Per-op cost profile of one dry-run cell, and the cell's step on one card.

The port's counterpart of ``repro/launch/profile_cell.py``.

* **On meta** (the default): the cell's step over the production mesh
  (``launch/dryrun.py``) under the op counter, and the top contributors per
  device by op × first output shape: bytes (the memory term), dot FLOPs (the
  compute term; a kernel's reported work under ``kernel <name>``) and
  collective bytes (by op, axes and size).
* **With** ``--device cuda --batch N``: the cell's step on one card at a
  batch that fits (the single-device model, random weights from a seed,
  the cell's sequence length; the reduction is printed), timed and traced
  under ``torch.profiler``: the top kernels by device time, the device's
  busy share, the step's ms, and its roofline share: the larger of the
  compute and memory terms of the same step at that batch (the op counter
  on ``meta``, one card, the H100's peaks) over the measured time, with the
  term that bounds it.  It fails where no card is found.

Usage:
  python -m repro_torch.launch.profile_cell --arch granite-8b \\
      --shape decode_32k --mesh single [--top 20] [--override '{...}']
  python -m repro_torch.launch.profile_cell --arch qwen2-1.5b \\
      --shape decode_32k --device cuda --batch 16
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import time
from typing import Any, Dict

import torch


def profile(arch: str, shape: str, mesh: str, top: int = 20,
            overrides=None) -> None:
    from repro_torch.launch.dryrun import build_cell, trace_cell

    cell, skip = build_cell(arch, shape, mesh, overrides)
    if cell is None:
        print(f"SKIP: {skip}")
        return
    cost, _ = trace_cell(cell)
    chips = math.prod(cell.plan.mesh.shape.values())
    per = cost.scaled(chips)
    print(f"=== {arch} × {shape} × {mesh} per-device profile "
          "(op counter on meta) ===")
    print(f"-- top {top} bytes (GB, per device per step) --")
    for k, v in per.bytes_by.most_common(top):
        print(f"  {v / 1e9:10.2f}  {k}")
    print(f"-- top {top} dot flops (GFLOP, per device) --")
    for k, v in per.flops_by.most_common(top):
        print(f"  {v / 1e9:10.2f}  {k}")
    print(f"-- top {top} collective bytes (GB, per device) --")
    for k, v in per.coll_by.most_common(top):
        print(f"  {v / 1e9:10.2f}  {k}")


# ---------------------------------------------------------------------------
# the cell's step on one card
# ---------------------------------------------------------------------------

def one_card_step(arch: str, shape_name: str, batch: int, device: Any,
                  seed: int = 0, overrides=None):
    """The cell's step at ``batch`` on one device: (a function running it
    once, the model, a description of the reduction).  Weights from a
    seeded generator on ``device`` (``meta``: shapes only); inputs drawn
    from the seed."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, input_specs
    from repro_torch.models import Model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.runtime.train_loop import (
        build_train_step,
        init_train_state,
    )

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    cut = dataclasses.replace(shape, global_batch=batch)
    opts = dict(attn_chunk=1024, loss_chunk=512, remat=True)
    opts.update(overrides or {})
    model = Model(cfg, **opts)
    device = torch.device(device)
    meta = device.type == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(seed)
    specs = input_specs(cfg, cut)

    def draw(spec, high=None):
        shp, dt = spec
        if meta:
            return torch.empty(shp, dtype=dt, device=device)
        if dt in (torch.int32, torch.int64):
            return torch.randint(0, high, shp, generator=gen, device=device,
                                 dtype=torch.int64)
        return torch.randn(shp, generator=gen, device=device).to(dt)

    note = (f"reduced: global batch {shape.global_batch} -> {batch} on one "
            f"card, sequence {shape.seq_len} as the cell")
    inputs = {k: draw(v, cfg.vocab_size) for k, v in specs.items()
              if k not in ("cache", "pos")}
    if shape.kind == "train":
        opt = adamw(cosine_warmup(3e-4, 2000, 100_000))
        state = init_train_state(model, opt, gen, device=device)
        step = build_train_step(model, opt)
        box = {"state": state}

        def run():
            box["state"], metrics = step(box["state"], inputs)
            return metrics
        return run, model, note
    params = model.init(gen, device=device)
    if shape.kind == "prefill":
        def run():
            with torch.no_grad():
                return model.prefill(params, inputs["tokens"],
                                     inputs.get("frontend_embed"))[0]
        return run, model, note
    cache = {k: (torch.empty(s, dtype=dt, device=device) if meta
                 else torch.zeros(s, dtype=dt, device=device))
             for k, (s, dt) in specs["cache"].items()}
    # every row decodes at the cache's last position: the whole cache read
    pos = torch.full((batch,), shape.seq_len - 1, dtype=torch.int64,
                     device=device)

    def run():
        with torch.no_grad():
            return model.decode_step(params, cache, inputs["tokens"], pos)[0]
    return run, model, note


def bounds(arch: str, shape_name: str, batch: int, overrides=None) -> dict:
    """The compute and memory terms of the one-card step at ``batch`` (the
    op counter on meta; the peaks of ``launch/mesh.py`` by the model's
    type)."""
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32
    from repro_torch.launch.op_costs import OpCounter

    run, model, _ = one_card_step(arch, shape_name, batch, "meta",
                                  overrides=overrides)
    with OpCounter() as counter:
        run()
    cost = counter.cost()
    peak = PEAK_FLOPS_BF16 if model.cfg.dtype == "bfloat16" \
        else PEAK_FLOPS_F32
    return {"flops": cost.flops, "bytes": cost.bytes_accessed,
            "t_compute_ms": cost.flops / peak * 1e3,
            "t_memory_ms": cost.bytes_accessed / HBM_BW * 1e3,
            "kernels": cost.kernels}


def profile_on_card(arch: str, shape_name: str, batch: int, *,
                    device: str = "cuda", top: int = 10, steps: int = 3,
                    overrides=None) -> dict:
    """The cell's step on one card (:func:`one_card_step`): step ms (the
    median of ``steps`` after a warm-up), one traced step's top kernels
    and busy share, and the roofline share against :func:`bounds`."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    if not torch.cuda.is_available():
        raise RuntimeError("profile_cell --device cuda: no CUDA device")
    dev = torch.device(device)
    run, model, note = one_card_step(arch, shape_name, batch, dev,
                                     overrides=overrides)
    print(f"=== {arch} × {shape_name} on {torch.cuda.get_device_name(dev)}"
          f" === {note}")
    run()                                             # warm-up, builds
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(steps):
        t = time.perf_counter()
        run()
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t) * 1e3)
    step_ms = statistics.median(times)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize(dev)
        traced_ms = (time.perf_counter() - t) * 1e3
    kernels: Dict[str, list] = {}
    busy_us = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            d = e.device_time
            busy_us += d
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += d
    busy = busy_us / 1e3 / traced_ms if traced_ms else 0.0
    b = bounds(arch, shape_name, batch, overrides)
    bound_ms = max(b["t_compute_ms"], b["t_memory_ms"])
    by = "compute" if b["t_compute_ms"] >= b["t_memory_ms"] else "memory"
    share = bound_ms / step_ms if step_ms else 0.0
    print(f"-- top {top} kernels by device time (one traced step, "
          f"{traced_ms:.2f} ms) --")
    for name, (n, us) in sorted(kernels.items(),
                                key=lambda kv: -kv[1][1])[:top]:
        print(f"  {us / 1e3:10.3f} ms  {n:5d}×  {name[:90]}")
    print(f"step {step_ms:.3f} ms (median of {steps}: "
          f"{', '.join(f'{x:.2f}' for x in times)}); device busy "
          f"{busy_us / 1e3:.3f} ms of the traced step ({traced_ms:.3f} ms): "
          f"share {busy:.3f}, {busy_us / 1e3 / step_ms:.3f} of the "
          "untraced step")
    print(f"roofline: compute {b['t_compute_ms']:.3f} ms, memory "
          f"{b['t_memory_ms']:.3f} ms at batch {batch}; the step reaches "
          f"{share:.3f} of its {by} bound")
    return {"arch": arch, "shape": shape_name, "batch": batch,
            "reduction": note, "step_ms": step_ms, "step_ms_all": times,
            "traced_ms": traced_ms, "busy_ms": busy_us / 1e3,
            "busy_share": busy, "busy_of_step": busy_us / 1e3 / step_ms,
            "t_compute_ms": b["t_compute_ms"],
            "t_memory_ms": b["t_memory_ms"], "bound_by": by,
            "roofline_share": share,
            "kernel_calls": {k: v["calls"] for k, v in b["kernels"].items()},
            "top_kernels": [(name, n, us / 1e3) for name, (n, us) in sorted(
                kernels.items(), key=lambda kv: -kv[1][1])[:top]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--override", default="")
    ap.add_argument("--device", default="meta",
                    help="meta (the dry run's counter) or cuda (one card)")
    ap.add_argument("--batch", type=int, default=1,
                    help="the batch of the one-card step (--device cuda)")
    args = ap.parse_args(argv)
    overrides = json.loads(args.override) if args.override else None
    if args.device == "meta":
        profile(args.arch, args.shape, args.mesh, args.top, overrides)
        return 0
    out = profile_on_card(args.arch, args.shape, args.batch,
                          device=args.device, top=args.top,
                          overrides=overrides)
    print(json.dumps({k: v for k, v in out.items() if k != "top_kernels"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
