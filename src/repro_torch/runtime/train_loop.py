"""Train-step builder of the port: gradient accumulation, clipping and
gradient compression, on one device or over a mesh.

``build_train_step`` returns ``step(state, batch) -> (new_state,
metrics)``, the counterpart of ``repro/runtime/train_loop.py``.  The step
is **out of place**: it returns a new :class:`TrainState` and never writes
into the one it is given (the parameters are differentiated through
detached views; the optimizer returns new tensors), so a caller that keeps
the old state — ``FaultTolerantTrainer``'s committed origin — can roll
back to it for free.  The metrics are device scalars; nothing here syncs
with the host.

Over a mesh (a ``Model`` with a training plan) one host process drives
every position, as XLA's partitioned step does in the JAX package.  The
state is stored as blocks (:func:`init_train_state`, ``shard_params``):
each parameter, moment and accumulator leaf a
:class:`~repro_torch.distributed.blocked.Blocked` whose blocks lie on the
cards of the mesh positions that own them.  Each data position's share of
the loss (``Model.position_loss``) is differentiated on its own, through
its rows and the pieces of the blocks its model positions gather at use;
autograd returns each block's gradient on the block's own card, and the
data positions' gradients are added block by block, in position order,
into an f32 accumulator laid out as the parameters (or ``grad_shardings``)
say: the reduce-scatter of FSDP leaves and the all-reduce of replicated
ones, in one order whatever the layout, and no position's whole gradient
tree on one card.  The optimizer then updates each block where it lies.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch import accounting
from repro_torch.distributed import blocked
from repro_torch.distributed.sharding import shard_params
from repro_torch.models.model import Model
from repro_torch.models.transformer import loss_mask
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
                     generator: Optional[torch.Generator] = None, *,
                     device: Any = None,
                     compress: Optional[str] = None) -> TrainState:
    """Random weights from ``generator`` (on its device), a fresh
    optimizer state and step 0.  Over a training plan the parameters are
    stored as blocks (``shard_params``; the whole tree is dropped once
    blocked) and the optimizer state is made from them, block by block,
    then laid out as ``param_shardings`` says for it (the JAX package's
    placement of the state).  With no generator and ``device="meta"``:
    the state's shapes, types and layout only."""
    params = model.init(generator, device=device)
    where = generator.device if generator is not None else device
    plan = model.plan
    if plan.dp_axes:
        params = shard_params(model.cfg, plan, params)
        opt_state = shard_params(model.cfg, plan, optimizer.init(params))
    else:
        opt_state = optimizer.init(params)
    return TrainState(
        params=params,
        opt_state=opt_state,
        ef=ef_init(params) if compress else None,
        step=torch.zeros((), dtype=torch.int32, device=where),
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


def sharded_value_and_grad(model: Model, params: Any,
                           batch: Dict[str, Any], grad_shardings: Any = None
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                      Any]:
    """:func:`value_and_grad` over the model's mesh, on parameters stored
    whole or as blocks: data position ``d``'s loss ``nll_d / N + w / D ·
    aux_d`` (``N`` the batch's count of positions carrying loss, ``D`` the
    data positions, ``w`` the aux weight) is differentiated on its own and
    its gradients (each block's on the block's device) added, position by
    position, into an f32 accumulator laid out as ``grad_shardings`` says
    (by default as the parameters are); the sum is the single-device
    loss's gradient.  The loss and metrics are the positions'
    :meth:`Model.combine`; the gradients come back in each leaf's type, in
    the accumulator's layout."""
    flat, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in flat]
    tree = pytree.tree_unflatten(leaves, spec)
    n_dp, w = model.plan.dp_size, model.moe_aux_weight
    s = batch["tokens"].shape[1]
    count = torch.clamp(loss_mask(model.cfg, s, batch["tokens"].device).sum()
                        * batch["tokens"].shape[0], min=1.0)
    acc: Any = None
    parts = []

    def position(d: int):
        nll, n_d, aux = model.position_loss(tree, batch, d)
        loss_d = nll / count.to(nll.device) + (w / n_dp) * aux
        # one thread runs the backward on every card: a remat'd layer spans
        # its model positions' cards, and two device threads unpacking one
        # checkpointed region would both recompute it
        with torch.autograd.set_multithreading_enabled(False):
            grads = torch.autograd.grad(loss_d, leaves, allow_unused=True)
        return nll, n_d, aux, pytree.tree_unflatten(
            [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)], spec)

    first = None            # kept only for the dry run's one of each
    for d, weight in accounting.repeats(n_dp):
        if weight:
            with accounting.scaled(weight):
                out = position(d)
            first = out if weight > 1 else None
        else:
            out = first
        nll, n_d, aux, grads = out
        del out
        if acc is None:
            # a copy: the accumulator is this step's own to add into
            acc = lay_out(pytree.tree_map(
                lambda g: g.to(torch.float32, copy=True), grads),
                grad_shardings)
        else:
            blocked.map_leaves(blocked.add_into, acc, grads)
        del grads
        parts.append((nll.detach(), n_d, aux.detach()))
    first = None
    _report_grad_sums(model, params)
    loss, metrics = model.combine(parts)
    grads = blocked.map_leaves(
        lambda a, p: pytree.tree_map(lambda x: x.to(p.dtype), a), acc, params)
    return loss, metrics, grads


def _report_grad_sums(model: Model, params: Any) -> None:
    """The op counter's account of the gradients' sum over the data
    positions (the adds into the accumulator run on each block's device):
    in the SPMD program each leaf's gradient is reduce-scattered over the
    data axes onto its blocks, or all-reduced where the leaf is not split
    over them, each position receiving its block."""
    plan = model.plan
    if not accounting.active() or plan.dp_size == 1:
        return
    n = math.prod(plan.mesh.shape.values())
    for x in blocked.leaves(params):
        nbytes = x.numel() * (x.blocks[0] if blocked.is_blocked(x)
                              else x).element_size()
        split = blocked.is_blocked(x) and any(
            a in plan.dp_axes for k in range(x.ndim)
            for a in x.sharding._axes(k))
        parts = math.prod(x.sharding.parts(x.ndim)) \
            if blocked.is_blocked(x) else 1
        accounting.collective("reduce-scatter" if split else "all-reduce",
                              nbytes / parts, n, plan.dp_axes)


def lay_out(tree: Any, shardings: Any) -> Any:
    """``tree`` laid out as ``shardings`` says (``None``, or a ``None``
    leaf: as it lies)."""
    if shardings is None:
        return tree
    return blocked.map_leaves(blocked.lay_out, tree, shardings)


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
    """The step on the model's device or over its plan's mesh.
    ``accum_steps`` splits the batch into microbatches whose gradients sum
    in an f32 accumulator; ``grad_shardings`` (e.g. ``param_shardings(...,
    zero1=True)``, the JAX package's ZeRO layout) lays that accumulator out
    (``None`` leaves and the single-device plan's tree of ``None`` change
    nothing), and the gradients are laid out as the parameters before the
    optimizer; ``compress`` runs the gradients through error-feedback
    compression; ``clip_norm`` clips by global norm."""
    distributed = model.plan.is_distributed

    def grad_fn(params: Any, batch: Dict[str, torch.Tensor]):
        if distributed:
            return sharded_value_and_grad(model, params, batch,
                                          grad_shardings)
        return value_and_grad(model, params, batch)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if accum_steps == 1:
            loss, metrics, grads = grad_fn(state.params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"accum_steps {accum_steps}")
            mb = {k: v.reshape(accum_steps, b // accum_steps, *v.shape[1:])
                  for k, v in batch.items()}
            grads, loss, first = None, 0.0, None
            for i, weight in accounting.repeats(accum_steps):
                if weight:
                    with accounting.scaled(weight):
                        out = grad_fn(state.params,
                                      {k: v[i] for k, v in mb.items()})
                    # kept only for the dry run's one of each
                    first = out if weight > 1 else None
                else:
                    out = first
                l_i, _, g = out
                del out
                # the accumulator is this step's own: add into it
                grads = (lay_out(pytree.tree_map(lambda x: x.float(), g),
                                 grad_shardings)
                         if grads is None else blocked.map_leaves(
                             blocked.add_into, grads, g))
                loss = loss + l_i
            grads = pytree.tree_map(lambda g: g / accum_steps, grads)
            loss = loss / accum_steps
            metrics = {"xent": loss, "moe_aux": torch.zeros_like(loss)}

        # each leaf's gradient where its parameter lies
        grads = blocked.tree_like(grads, state.params)
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
