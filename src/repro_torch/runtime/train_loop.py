"""Train-step builder of the port: gradient accumulation, clipping and
gradient compression over one card.

``build_train_step`` returns ``step(state, batch) -> (new_state,
metrics)``, the counterpart of ``repro/runtime/train_loop.py``.  The step
is **out of place**: it returns a new :class:`TrainState` and never writes
into the one it is given (the parameters are differentiated through
detached views; the optimizer returns new tensors), so a caller that keeps
the old state — ``FaultTolerantTrainer``'s committed origin — can roll
back to it for free.  The metrics are device scalars; nothing here syncs
with the host.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.models.model import Model
from repro_torch.optim import (
    Optimizer,
    clip_by_global_norm,
    compressed_gradients,
)
from repro_torch.optim.compress import ErrorFeedbackState, ef_init


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    ef: Optional[ErrorFeedbackState]  # gradient-compression residual
    step: torch.Tensor


def init_train_state(model: Model, optimizer: Optimizer,
                     generator: torch.Generator, *,
                     compress: Optional[str] = None) -> TrainState:
    """Random weights from ``generator`` (on its device), a fresh
    optimizer state and step 0."""
    params = model.init(generator)
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        ef=ef_init(params) if compress else None,
        step=torch.zeros((), dtype=torch.int32, device=generator.device),
    )


def value_and_grad(model: Model, params: Any, batch: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, metrics, grads) of ``model.loss`` at ``params``, which are
    read, never written: the gradients are taken for detached views of
    them.  A leaf the loss does not reach gets a zero gradient."""
    flat, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in flat]
    loss, metrics = model.loss(pytree.tree_unflatten(leaves, spec), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            pytree.tree_unflatten(grads, spec))


def build_train_step(
    model: Model,
    optimizer: Optimizer,
    *,
    accum_steps: int = 1,
    clip_norm: Optional[float] = 1.0,
    compress: Optional[str] = None,
    grad_shardings: Any = None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]],
              Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The step over one card.  ``accum_steps`` splits the batch into
    microbatches whose gradients sum in an f32 accumulator; ``compress``
    runs the gradients through error-feedback compression; ``clip_norm``
    clips by global norm.  ``grad_shardings`` (the JAX package's ZeRO
    accumulator layout) has no meaning on one card and raises."""
    if grad_shardings is not None:
        raise NotImplementedError(
            "grad_shardings lays the accumulator out over a mesh; the port "
            "trains on one card (multi-GPU: ROADMAP)")

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if accum_steps == 1:
            loss, metrics, grads = value_and_grad(model, state.params,
                                                  batch)
        else:
            b = batch["tokens"].shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"accum_steps {accum_steps}")
            mb = {k: v.reshape(accum_steps, b // accum_steps, *v.shape[1:])
                  for k, v in batch.items()}
            grads, loss = None, 0.0
            for i in range(accum_steps):
                l_i, _, g = value_and_grad(
                    model, state.params, {k: v[i] for k, v in mb.items()})
                # the accumulator is this step's own: add into it
                grads = (pytree.tree_map(lambda x: x.float(), g)
                         if grads is None else pytree.tree_map(
                             lambda a, x: a.add_(x), grads, g))
                loss = loss + l_i
            grads = pytree.tree_map(lambda g: g / accum_steps, grads)
            loss = loss / accum_steps
            metrics = {"xent": loss, "moe_aux": torch.zeros_like(loss)}

        ef = state.ef
        if compress and ef is not None:
            grads, ef = compressed_gradients(grads, ef, method=compress)
        gnorm = torch.zeros_like(loss)
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        params, opt_state = optimizer.step(grads, state.opt_state,
                                           state.params)
        return (TrainState(params=params, opt_state=opt_state, ef=ef,
                           step=state.step + 1),
                {"loss": loss, "grad_norm": gnorm, **metrics})

    return step
