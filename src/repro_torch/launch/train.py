"""Training entry point of the port::

    python -m repro_torch.launch.train --arch qwen2-1.5b --batch 4 --seq 2048

The port's copy of ``repro/launch/train.py`` with its flags and
``--device`` added: it runs on the card (``cuda`` unless ``--device``
names another device; without CUDA it raises).  ``--smoke`` trains the
config's ``reduced()`` form in float32 at batch 2, sequence 32, for 10
steps (with ``--device cpu`` that runs anywhere).  Parameters come from
the port's seeded init, tokens from the synthetic pipeline (seed 7), and
the run goes through ``FaultTolerantTrainer`` with a ``CheckpointManager``
under ``--ckpt-dir`` (by default ``branchx-ckpt`` in the temporary
directory).  It prints ``done: step N loss X rollbacks R``.

``--distributed`` plans a mesh over the visible cards when there are more
than one, as the JAX package plans over its devices: ``plan_mesh``,
``Model(cfg, plan=plan)``, the parameters and the optimizer state stored
as the blocks ``param_shardings`` names (``init_train_state`` over the
plan: each card holds the blocks its positions own, and the gradient
accumulator is laid out the same way), and one process driving every
position (the data pipeline is shard 0 of 1).  It prints ``training
mesh: ...`` first.  With one device (one card, or ``--device cpu``) it
trains single-device and says so.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import List

import torch


def distributed_devices(device: torch.device) -> List[torch.device]:
    """The devices ``--distributed`` plans over: every visible card for a
    bare ``cuda``, else the one device named."""
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "branchx-ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--compress-grads", default=None,
                    choices=[None, "int8", "topk"])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, float32, CPU-sized")
    ap.add_argument("--distributed", action="store_true",
                    help="plan a (data, model) mesh over the visible "
                    "cards, the state stored as blocks over them")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without one) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import SyntheticLMPipeline
    from repro_torch.device import resolve_device
    from repro_torch.distributed.mesh import SINGLE_DEVICE
    from repro_torch.models import Model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.runtime.elastic import plan_mesh
    from repro_torch.runtime.fault import FaultTolerantTrainer
    from repro_torch.runtime.train_loop import build_train_step, \
        init_train_state

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(reduced(cfg), dtype="float32")
        args.batch, args.seq, args.steps = 2, 32, 10
    plan = SINGLE_DEVICE
    if args.distributed:
        devices = distributed_devices(device)
        if len(devices) > 1:
            plan = plan_mesh(devices)
            device = plan.grid[0][0]
            print(f"training mesh: {plan.mesh}")
        else:
            print(f"--distributed with one visible device: training "
                  f"single-device on {device}")
    model = Model(cfg, plan=plan, attn_chunk=min(256, args.seq),
                  loss_chunk=min(128, args.seq))
    opt = adamw(cosine_warmup(args.lr, max(args.steps // 20, 1),
                              args.steps))
    step = build_train_step(model, opt, accum_steps=args.accum,
                            compress=args.compress_grads)
    # over a mesh: the parameters and the optimizer state as blocks
    state = init_train_state(
        model, opt, torch.Generator(device=device).manual_seed(0),
        compress=args.compress_grads)
    # one process drives every mesh position: it reads shard 0 of 1
    data = SyntheticLMPipeline(cfg, batch=args.batch, seq=args.seq, seed=7,
                               shard=0, num_shards=1, device=device)
    trainer = FaultTolerantTrainer(
        step_fn=step, state=state, data=data,
        ckpt=CheckpointManager(args.ckpt_dir), ckpt_every=args.ckpt_every)
    trainer.run(args.steps)
    m = trainer.metrics_log[-1]
    print(f"done: step {trainer.steps_done} loss {m['loss']:.4f} "
          f"rollbacks {trainer.rollbacks}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
