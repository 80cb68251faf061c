"""AdamW with f32 moments (params may be bf16 — the moments are the master
precision, the standard large-model configuration)."""

from __future__ import annotations

from typing import Any, Callable, Union

import torch

from repro_torch.optim.base import (
    Optimizer,
    step_leaves,
    update_leaves,
    zeros_f32,
)
from repro_torch.optim.schedules import constant

Schedule = Callable[[torch.Tensor], torch.Tensor]


def adamw(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    lr_fn = lr if callable(lr) else constant(lr)

    def init(params: Any) -> Any:
        dev = next(iter(torch.utils._pytree.tree_leaves(params))).device
        return {"mu": zeros_f32(params), "nu": zeros_f32(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def rule(state: Any):
        """The step's per-leaf rule; the bias corrections and the rate are
        device scalars computed from the device step (no host sync),
        copied to each leaf's device where it lies on another card (a
        block of a leaf stored over a mesh)."""
        step = state["step"] + 1
        scalars = (lr_fn(step), 1.0 - b1 ** step.float(),
                   1.0 - b2 ** step.float())
        on = {}

        def leaf(g, p, mu, nu):
            if p.device not in on:
                on[p.device] = tuple(torch.as_tensor(x, device=p.device)
                                     for x in scalars)
            lr_t, b1c, b2c = on[p.device]
            g = g.float()
            mu = b1 * mu + (1 - b1) * g
            nu = b2 * nu + (1 - b2) * torch.square(g)
            u = -lr_t * ((mu / b1c) / (torch.sqrt(nu / b2c) + eps)
                         + weight_decay * p.float())
            return u, mu, nu
        return leaf, step

    def update(grads: Any, state: Any, params: Any):
        leaf, step = rule(state)
        updates, mu, nu = update_leaves(leaf, grads, params, state["mu"],
                                        state["nu"])
        return updates, {"mu": mu, "nu": nu, "step": step}

    def step_fn(grads: Any, state: Any, params: Any):
        leaf, step = rule(state)
        new_params, mu, nu = step_leaves(leaf, grads, params, state["mu"],
                                         state["nu"])
        return new_params, {"mu": mu, "nu": nu, "step": step}

    return Optimizer(init=init, update=update, step=step_fn)
