"""Optimizer interface: (init, update) pairs over parameter trees, and the
leaf-by-leaf step the train loop takes.  A leaf stored as blocks
(``distributed.blocked.Blocked``) is a node whose children are its
blocks, so every per-leaf rule runs block by block where each block
lies."""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.distributed.blocked import tree_like

#: leaf -> (update f32, *new state leaves): the per-leaf rule of an update
LeafRule = Callable[..., Tuple[torch.Tensor, ...]]

#: a leaf larger than this is stepped by :func:`step_leaves` in slices of
#: its leading axis of at most this many elements (at least one row), so
#: the f32 temporaries of a stacked [L, ...] leaf or an embedding never
#: exist for the whole leaf at once
ROW_STEP_ELEMENTS = 1 << 26


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    #: update(grads, state, params) -> (updates, new_state)
    update: Callable[[Any, Any, Any], Any]
    #: step(grads, state, params) -> (new_params, new_state): ``update``
    #: and :func:`apply_updates` in one pass, each leaf's f32 update
    #: dropped as soon as it is applied
    step: Callable[[Any, Any, Any], Any]


def map_leaves(fn: Callable[..., Tuple], *trees: Any) -> List[Any]:
    """``fn`` over the leaves of trees of one structure; its tuple results
    come back as one tree each."""
    flat, specs = zip(*(pytree.tree_flatten(t) for t in trees))
    spec = specs[0]
    if any(s != spec for s in specs[1:]):
        raise ValueError("trees of different structures or block layouts")
    outs = [fn(*leaves) for leaves in zip(*flat)]
    return [pytree.tree_unflatten(list(o), spec) for o in zip(*outs)]


def zeros_f32(tree: Any) -> Any:
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        tree)


def apply_updates(params: Any, updates: Any) -> Any:
    return pytree.tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def update_leaves(rule: LeafRule, grads: Any, params: Any,
                  *state: Any) -> List[Any]:
    """(updates, *new state trees) of ``rule(g, p, *state_leaves)``."""
    return map_leaves(rule, grads, params, *state)


def step_leaves(rule: LeafRule, grads: Any, params: Any,
                *state: Any) -> List[Any]:
    """(new params, *new state trees): ``rule`` and the update's
    application per leaf, a large leaf a slice of rows at a time (each
    slice written into the leaf's new tensors, which no one else holds
    yet).  A state leaf laid out otherwise than its parameter (the JAX
    package's ZeRO-1 split of the moments over ``("pod", "data")``) is
    stepped in the parameter's layout and stored back in its own."""
    def one(g, p, *s):
        if p.numel() <= ROW_STEP_ELEMENTS or p.dim() < 2:
            u, *new_s = rule(g, p, *s)
            return (p + u.to(p.dtype), *new_s)
        rows = max(1, ROW_STEP_ELEMENTS // p[0].numel())
        out = [torch.empty_like(p)] + [torch.empty_like(x) for x in s]
        for i in range(0, p.shape[0], rows):
            sl = slice(i, i + rows)
            u, *new_s = rule(g[sl], p[sl], *(x[sl] for x in s))
            out[0][sl] = p[sl] + u.to(p.dtype)
            for dst, src in zip(out[1:], new_s):
                dst[sl] = src
        return tuple(out)
    new_params, *new_state = map_leaves(
        one, grads, params, *(tree_like(s, params) for s in state))
    return [new_params] + [tree_like(n, s)
                           for n, s in zip(new_state, state)]
