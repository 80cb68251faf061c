"""Device-side agentic exploration — fork/explore/commit inside one program.

The port's copy of ``repro/core/explore.py``.  Sibling branches live in a
stacked leading axis of the state pytree and first-commit-wins is a
reduction, so a round runs on the card with no host synchronisation:

* :func:`fork_stacked` — O(1)-per-branch fork: ``expand`` gives each leaf
  a leading branch axis as a view (no device copy, as ``broadcast_to`` in
  JAX).  The frozen origin is structural only while nothing writes into a
  view, so step functions must be functional, as they are under
  ``jax.vmap``: return new tensors, never write into the state given.
* :func:`first_commit_wins` — deterministic winner selection: ``argmin``
  over ``where(success, commit_time, finfo.max)``; ``torch.argmin``
  returns the first minimum, so ties break to the lowest branch index,
  the total order of the kernel's exclusive commit group.
* :func:`select_branch` — the commit: gather the winner's leaves with
  ``index_select`` on a device index (no ``.item()``).
* :func:`explore` — one fork/explore/commit round under
  ``torch.func.vmap``.

Randomness.  JAX splits a key per branch; a ``torch.Generator`` cannot be
split inside ``vmap``.  This module therefore uses counter-based keys made
of tensor ops: a key is an ``int64`` tensor of two 32-bit words, drawn once
per round from the caller's ``generator`` on the state's device
(:func:`key_from`).  :func:`split` and :func:`fold_in` derive keys by
hashing, and :func:`uniform`/:func:`normal` turn a key into values.  Step
and perturb functions receive one key per branch and draw from it with
these functions, never from torch's global generators (the vmap runs with
``randomness="error"``).  Integer hashing is exact, so a key gives the same
bits on the card and on the CPU.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch
import torch.utils._pytree as pytree

_M32 = 0xFFFFFFFF


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash of ``int64`` words (or Python ints) in
    ``[0, 2**32)``.  Every product stays below ``2**63`` (multipliers below
    ``2**31``)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def key_from(generator: Union[torch.Generator, int],
             device: Any = None) -> torch.Tensor:
    """A fresh key drawn from ``generator`` (a ``torch.Generator``, or an
    int seed for a new generator on ``device``), on the generator's
    device: no host round trip."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(
            device=torch.device("cpu" if device is None else device)
        ).manual_seed(int(generator))
    return torch.randint(0, 2 ** 32, (2,), generator=generator,
                         device=generator.device, dtype=torch.int64)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """A key derived from ``key`` and the integer ``data`` (hashed on the
    host: ``_mix`` runs on Python ints too)."""
    return torch.stack([_mix(key[0] ^ _mix(2 * data + 1)),
                        _mix(key[1] ^ _mix(2 * data + 2))])


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` independent keys, ``int64[n, 2]``."""
    i = torch.arange(n, device=key.device, dtype=torch.int64)
    return torch.stack([_mix(key[0] ^ _mix(2 * i + 0x3C6EF372)),
                        _mix(key[1] ^ _mix(2 * i + 0x3C6EF373))], dim=-1)


def _bits(key: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    c = torch.arange(math.prod(shape), device=key.device, dtype=torch.int64)
    return _mix(_mix(key[0] ^ _mix(c)) ^ key[1]).reshape(shape)


def uniform(key: torch.Tensor, shape: Tuple[int, ...] = (),
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Uniform values in ``[0, 1)`` from ``key`` (24 random bits each)."""
    return ((_bits(key, tuple(shape)) >> 8).to(torch.float32)
            * 2.0 ** -24).to(dtype)


def normal(key: torch.Tensor, shape: Tuple[int, ...] = (),
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normal values from ``key`` (Box-Muller)."""
    u1 = uniform(fold_in(key, 0), shape)
    u2 = uniform(fold_in(key, 1), shape)
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    return (r * torch.cos((2.0 * math.pi) * u2)).to(dtype)


def fork_stacked(state: Any, n: int) -> Any:
    """Fork ``n`` sibling copies of ``state`` along a new leading axis.

    ``expand`` makes a view, so no device copy happens until a branch
    computes its own leaf — the CoW analogue.
    """
    def stack(x: Any) -> torch.Tensor:
        x = torch.as_tensor(x)
        return x.unsqueeze(0).expand((n,) + tuple(x.shape))
    return pytree.tree_map(stack, state)


def perturbed_fork(
    state: Any,
    n: int,
    perturb_fn: Callable[[Any, torch.Tensor, torch.Tensor], Any],
    generator: Union[torch.Generator, int, torch.Tensor],
) -> Any:
    """Fork ``n`` branches, each perturbed by ``perturb_fn(state, key_i, i)``.

    This is the "explore" setup for speculative training: each branch gets
    an independent key and its branch index (e.g. to scale a
    hyperparameter).  ``generator`` may also be a key (:func:`key_from`).
    """
    key = generator if isinstance(generator, torch.Tensor) else key_from(
        generator, _device_of(state))
    keys = split(key, n)
    idx = torch.arange(n, device=keys.device)
    return torch.func.vmap(lambda k, i: perturb_fn(state, k, i))(keys, idx)


def first_commit_wins(
    success: torch.Tensor,
    commit_time: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve the exclusive commit group.

    Args:
      success: bool[N] — which branches attempt a commit.
      commit_time: optional float/int[N] — arrival order of the commit
        attempts; earliest successful one wins.  Defaults to branch index
        (synchronous step ⇒ index order is arrival order).

    Returns:
      (winner_index: int32 scalar, any_success: bool scalar), both on
      ``success``'s device.  If no branch succeeds, ``winner_index`` is 0
      and ``any_success`` is False (caller keeps the frozen origin — "if
      all branches abort, the parent resumes").
    """
    n = success.shape[0]
    if commit_time is None:
        commit_time = torch.arange(n, dtype=torch.float32,
                                   device=success.device)
    commit_time = commit_time.to(torch.float32)
    big = torch.finfo(torch.float32).max
    keyed = torch.where(success, commit_time, big)
    winner = torch.argmin(keyed).to(torch.int32)
    return winner, torch.any(success)


def select_branch(stacked: Any, index: Union[torch.Tensor, int]) -> Any:
    """Commit: extract branch ``index`` from every stacked leaf."""
    def pick(x: torch.Tensor) -> torch.Tensor:
        i = torch.as_tensor(index, device=x.device).to(torch.int64)
        return torch.index_select(x, 0, i.reshape(1)).squeeze(0)
    return pytree.tree_map(pick, stacked)


class ExploreResult(NamedTuple):
    state: Any                # committed state (origin if nothing succeeded)
    winner: torch.Tensor      # int32 — winning branch index
    committed: torch.Tensor   # bool — did any branch commit?
    aux: Any                  # stacked per-branch auxiliary outputs


def _device_of(tree: Any) -> Optional[torch.device]:
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def explore(
    step_fn: Callable[[Any, torch.Tensor], Tuple[Any, torch.Tensor, Any]],
    origin: Any,
    n: int,
    generator: Union[torch.Generator, int, torch.Tensor],
    *,
    perturb_fn: Optional[Callable[[Any, torch.Tensor, torch.Tensor],
                                  Any]] = None,
    commit_time_fn: Optional[Callable[[Any], torch.Tensor]] = None,
) -> ExploreResult:
    """One fork/explore/commit round, with no host synchronisation.

    ``step_fn(branch_state, key) -> (new_state, success, aux)`` runs in
    parallel over ``n`` branches via ``torch.func.vmap``.  The first
    successful branch (per :func:`first_commit_wins`) commits; if none
    succeeds the frozen origin is returned unchanged.  ``generator`` (a
    ``torch.Generator`` on the state's device, an int seed, or a key)
    seeds the round's keys.
    """
    key = generator if isinstance(generator, torch.Tensor) else key_from(
        generator, _device_of(origin))
    if perturb_fn is not None:
        branches = perturbed_fork(origin, n, perturb_fn, key)
    else:
        branches = fork_stacked(origin, n)
    keys = split(fold_in(key, 1), n)
    new_states, success, aux = torch.func.vmap(step_fn)(branches, keys)
    success = success.reshape((n,)).to(torch.bool)
    commit_time = commit_time_fn(aux) if commit_time_fn is not None else None
    winner, any_success = first_commit_wins(success, commit_time)
    winner_state = select_branch(new_states, winner)
    committed = pytree.tree_map(
        lambda w, o: torch.where(any_success.reshape((1,) * w.dim()), w,
                                 torch.as_tensor(o, device=w.device)),
        winner_state,
        origin,
    )
    return ExploreResult(state=committed, winner=winner,
                         committed=any_success, aux=aux)


__all__ = ["ExploreResult", "explore", "first_commit_wins", "fold_in",
           "fork_stacked", "key_from", "normal", "perturbed_fork",
           "select_branch", "split", "uniform"]
