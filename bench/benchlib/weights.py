"""Weights drawn from the run's seed on the device, one call per leaf.

The tree's layout (names, shapes, types) is what the port's
``Model.init(device="meta")`` describes; the values are the benchmark's own:
Normal(0, 1/fan_in) for every matrix, 1 + Normal(0, 0.1) for norm scales.
The same tensors go to the port and to the reference."""

from __future__ import annotations

import math
from typing import Any, Tuple

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


def draw(like: Any, seed: int, device: Any) -> Any:
    """A tree shaped like ``like`` (tensors on ``meta``), every leaf drawn
    on ``device`` from one generator seeded with ``seed``, in tree order."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def leaf(name: str, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(t.shape, dtype=t.dtype, device=device)
        if name in NORMS:
            return out.normal_(1.0, 0.1, generator=gen)
        if name.startswith("b"):            # biases
            return out.normal_(0.0, 0.02, generator=gen)
        std = 1.0 / math.sqrt(fan_in(name, tuple(t.shape)))
        return out.normal_(0.0, std, generator=gen)

    def walk(name: str, x: Any) -> Any:
        if isinstance(x, dict):
            return {k: walk(k, v) for k, v in x.items()}
        return leaf(name, x)

    return walk("", like)

