"""Speculative training through the BranchContext subsystem, the PyTorch
port: the twin of ``examples/speculative_train.py``.  Every step forks K
candidate update branches (different LR multipliers), runs them in
parallel under ``torch.func.vmap`` (the flash attention kernel launched
once for all branches on the card), and commits the one with the best
validation loss: first-commit-wins as a training-time primitive (paper
§8).

Run:  PYTHONPATH=src python examples/speculative_train_torch.py [--device cpu]
"""

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.explore import fold_in, key_from
from repro_torch.data import SyntheticLMPipeline
from repro_torch.device import resolve_device
from repro_torch.explore_ctx import SpeculativeTrainer
from repro_torch.models import Model
from repro_torch.optim import adamw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without one) or cpu "
                         "(the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # d_model 128 (head dim 32, the flash attention kernel's smallest)
    # where the JAX example's reduced() keeps 64 (head dim 16)
    cfg = dataclasses.replace(reduced(get_config("qwen2-1.5b"), d_model=128),
                              dtype="float32")
    model = Model(cfg, attn_chunk=8, loss_chunk=8, remat=False)
    data = SyntheticLMPipeline(cfg, batch=4, seq=32, seed=1, device=device)
    val_batch = data.peek(10_000)  # held-out

    trainer = SpeculativeTrainer(model, adamw(1e-3), n_branches=4)
    state = trainer.init(torch.Generator(device=device).manual_seed(0))
    key = key_from(0, device)

    for step in range(15):
        state, info = trainer.step(state, fold_in(key, step), data.next(),
                                   val_batch)
        vals = [f"{v:.3f}" for v in info["val_losses"]]
        print(f"step {step:02d} committed branch {info['winner']} "
              f"val-losses {vals}")
    print("speculative training complete")


if __name__ == "__main__":
    main()
