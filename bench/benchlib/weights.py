"""Weights drawn from the run's seed on the device, one call per leaf.

The tree's layout (names, shapes, types) is what the port's
``Model.init(device="meta")`` describes; the values are the benchmark's own:
Normal(0, 1/fan_in) for every matrix, 1 + Normal(0, 0.1) for norm scales.
The same tensors go to the port and to the reference.

A configuration served over ``tp`` shards is drawn shard by shard
(:func:`draw_shards`): no device ever holds a whole leaf that the serving
specs split."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

NORMS = ("ln1", "ln2", "ln", "final_norm")


def fan_in(name: str, shape: Tuple[int, ...]) -> int:
    """The contracted width of a leaf: q/k/v ``[.., d, heads, hd]`` contract
    d, ``wo`` ``[.., heads, hd, d]`` contracts heads·hd, the embedding
    ``[V, d]`` is scaled by d, every other matrix contracts its second last
    dimension."""
    if name in ("wq", "wk", "wv"):
        return shape[-3]
    if name == "wo":
        return shape[-3] * shape[-2]
    if name == "embed":
        return shape[-1]
    return shape[-2]


def _fill(name: str, whole: Tuple[int, ...], out: torch.Tensor,
          gen: torch.Generator) -> torch.Tensor:
    """``out`` (a leaf named ``name`` of shape ``whole``, or a block of it)
    drawn in place from ``gen`` by the leaf's rule."""
    if name in NORMS:
        return out.normal_(1.0, 0.1, generator=gen)
    if name.startswith("b"):            # biases
        return out.normal_(0.0, 0.02, generator=gen)
    std = 1.0 / math.sqrt(fan_in(name, whole))
    return out.normal_(0.0, std, generator=gen)


def _map(fn: Callable[[str, Any], Any], tree: Any, name: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


def draw(like: Any, seed: int, device: Any) -> Any:
    """A tree shaped like ``like`` (tensors on ``meta``), every leaf drawn
    on ``device`` from one generator seeded with ``seed``, in tree order."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def leaf(name: str, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(t.shape, dtype=t.dtype, device=device)
        return _fill(name, tuple(t.shape), out, gen)

    return _map(leaf, like)


@dataclass
class Blocks:
    """One leaf as its tp shards hold it: ``parts[r]`` on shard ``r``'s
    device, the leaf cut into equal blocks along ``axis``; where ``axis`` is
    None every shard holds the whole leaf, the parts alike bit for bit."""

    parts: List[torch.Tensor]
    axis: Optional[int]


def shard_seed(seed: int, rank: int) -> int:
    """The seed of shard ``rank``'s generator in a draw from ``seed``."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(
        1, np.uint64)[0])


def draw_shards(like: Any, axes: Any, devices: Sequence[Any],
                seed: int) -> Any:
    """A tree of :class:`Blocks` shaped like ``like`` (tensors on ``meta``),
    cut over ``len(devices)`` shards: ``axes`` gives each leaf's split axis
    (None: kept whole).  A split leaf is drawn block by block, each on its
    shard's device from that shard's generator (:func:`shard_seed`), by the
    whole leaf's rule (its fan-in counts the whole contracted width); a
    whole leaf is drawn once on the first shard's device and copied to the
    others.  Leaves are drawn in tree order."""
    n = len(devices)
    gens = [torch.Generator(device=d).manual_seed(shard_seed(seed, r))
            for r, d in enumerate(devices)]

    def leaf(name: str, pair: Tuple[torch.Tensor, Optional[int]]) -> Blocks:
        t, axis = pair
        whole = tuple(t.shape)
        if axis is None:
            x = _fill(name, whole, torch.empty(
                whole, dtype=t.dtype, device=devices[0]), gens[0])
            return Blocks([x if torch.device(d) == x.device else x.to(d)
                           for d in devices], None)
        shape = tuple(s // n if i == axis else s for i, s in enumerate(whole))
        return Blocks([_fill(name, whole, torch.empty(
            shape, dtype=t.dtype, device=d), g)
            for d, g in zip(devices, gens)], axis)

    return _map(leaf, _zip(like, axes))


def _zip(like: Any, axes: Any) -> Any:
    if isinstance(like, dict):
        return {k: _zip(v, axes[k]) for k, v in like.items()}
    return like, axes


def shard_trees(tree: Any, n: int) -> List[Any]:
    """A tree of :class:`Blocks` as one plain tree per shard."""
    return [_map(lambda _, b: b.parts[r], tree) for r in range(n)]
