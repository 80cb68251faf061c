"""SGD with (Nesterov) momentum."""

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


def sgd_momentum(lr: Union[float, Callable], momentum: float = 0.9,
                 nesterov: bool = False) -> Optimizer:
    lr_fn = lr if callable(lr) else constant(lr)

    def init(params: Any) -> Any:
        dev = next(iter(torch.utils._pytree.tree_leaves(params))).device
        return {"velocity": zeros_f32(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def rule(state: Any):
        """The per-leaf rule; the rate is copied to each leaf's device
        where it lies on another card (a block stored over a mesh)."""
        step = state["step"] + 1
        rate = lr_fn(step)
        on = {}

        def leaf(g, p, v):
            if p.device not in on:
                on[p.device] = torch.as_tensor(rate, device=p.device)
            lr_t = on[p.device]
            g = g.float()
            v = momentum * v + g
            d = g + momentum * v if nesterov else v
            return -lr_t * d, v
        return leaf, step

    def update(grads: Any, state: Any, params: Any):
        leaf, step = rule(state)
        updates, vel = update_leaves(leaf, grads, params, state["velocity"])
        return updates, {"velocity": vel, "step": step}

    def step_fn(grads: Any, state: Any, params: Any):
        leaf, step = rule(state)
        new_params, vel = step_leaves(leaf, grads, params,
                                      state["velocity"])
        return new_params, {"velocity": vel, "step": step}

    return Optimizer(init=init, update=update, step=step_fn)
