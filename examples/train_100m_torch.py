"""End-to-end training driver, the PyTorch port: the twin of
``examples/train_100m.py``.  A ~100M-parameter decoder trained on the
synthetic pipeline with the production stack: fault-tolerant
branch-context stepping (``FaultTolerantTrainer``), checkpoints as
BranchFS commits (``CheckpointManager``), metrics.

The default config is the real ~100M model (qwen2 family: 12L, d=768,
12H, kv=4, ff=2048, 32k vocab), field for field the JAX example's;
``--smoke`` shrinks everything for the CPU.  On the card attention runs
the flash attention kernel under autograd.

Run:  PYTHONPATH=src python examples/train_100m_torch.py [--steps 300]
      PYTHONPATH=src python examples/train_100m_torch.py --smoke --device cpu
"""

import argparse
import dataclasses
import tempfile

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data import SyntheticLMPipeline
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.runtime.fault import FaultTolerantTrainer
from repro_torch.runtime.train_loop import build_train_step, init_train_state


def config_100m() -> ArchConfig:
    return ArchConfig(
        name="train-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32_000,
        mlp_activation="swiglu", dtype="float32",
    )


def config_smoke() -> ArchConfig:
    return dataclasses.replace(
        config_100m(), num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=512)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="steps between checkpoints (default: a quarter "
                         "of the steps, at least 5, as the JAX example)")
    ap.add_argument("--log-every", type=int, default=None,
                    help="steps between log lines, each also a checkpoint "
                         "(FaultTolerantTrainer.run commits one as it "
                         "returns; default: a twentieth of the steps, as "
                         "the JAX example)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without one) or cpu "
                         "(the kernels' plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = config_smoke() if args.smoke else config_100m()
    if args.smoke:
        args.steps, args.batch, args.seq = 20, 2, 32
    n_params = cfg.param_count()
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"steps={args.steps} batch={args.batch} seq={args.seq} "
          f"device={device}")

    model = Model(cfg, attn_chunk=min(256, args.seq),
                  loss_chunk=min(128, args.seq), remat=not args.smoke)
    opt = adamw(cosine_warmup(3e-4, args.steps // 10 + 1, args.steps))
    step = build_train_step(model, opt)
    state = init_train_state(model, opt,
                             torch.Generator(device=device).manual_seed(0))
    data = SyntheticLMPipeline(cfg, batch=args.batch, seq=args.seq,
                               seed=17, device=device)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="branchx-100m-")
    trainer = FaultTolerantTrainer(
        step_fn=step, state=state, data=data,
        ckpt=CheckpointManager(ckpt_dir),
        ckpt_every=args.ckpt_every or max(args.steps // 4, 5))
    log_every = args.log_every or max(args.steps // 20, 1)
    for start in range(0, args.steps, log_every):
        n = min(log_every, args.steps - start)
        trainer.run(n)
        m = trainer.metrics_log[-1]
        print(f"step {trainer.steps_done:4d} loss {m['loss']:.4f} "
              f"gnorm {m['grad_norm']:.3f}")
    first, last = trainer.metrics_log[0], trainer.metrics_log[-1]
    print(f"loss {first['loss']:.4f} -> {last['loss']:.4f} "
          f"({trainer.rollbacks} rollbacks, checkpoints in {ckpt_dir})")
    assert last["loss"] < first["loss"], "training did not improve"


if __name__ == "__main__":
    main()
