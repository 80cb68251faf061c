"""The collectives of the port: the sum over shards, the gather along a
dimension, the int8-quantized sum, the ring all-reduce and the gradient
reduction over pods.

Counterparts of the ``jax.lax.psum`` and ``jax.lax.all_gather(...,
tiled=True)`` that the JAX package's sharded steps run inside
``shard_map``, and of ``psum_quantized``, ``ring_allreduce`` and
``allreduce_grads_over_pod`` in ``repro/distributed/collectives.py``.  One
host process holds every shard's tensor, so a collective takes the
shards' tensors as a list, one per position on the axis.  :func:`psum`
and :func:`all_gather` return one tensor on shard 0's device: each partial
is copied there (a no-op when it already lies there, a peer-to-peer copy
from another card) and combined in shard order, so a run is reproducible
whatever the layout; :func:`broadcast` copies a result back to every
shard.  The training collectives return one tensor per position, as the
JAX package's return one per shard.

Each call reports the SPMD collective it stands for to the active op
counter (:func:`repro_torch.accounting.collective`: the output-shape bytes
on each participating position, the JAX package's accounting), over the
mesh ``axes`` its caller names; the copies the port issues to implement it
count as nothing more.  :func:`broadcast` reports nothing: it hands a
replicated value (a sum's result, a normed input) to the positions that
hold it in the SPMD program.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import torch
import torch.utils._pytree as pytree

from repro_torch import accounting


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def psum(parts: Sequence[torch.Tensor], axes: Sequence[str] = ()
         ) -> torch.Tensor:
    """The sum of the shards' partials, on the first one's device, added
    in shard order (an all-reduce over ``axes``)."""
    if len(parts) > 1:
        accounting.collective("all-reduce", _nbytes(parts[0]), len(parts),
                              axes)
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


def all_gather(parts: Sequence[torch.Tensor], dim: int,
               axes: Sequence[str] = ()) -> torch.Tensor:
    """The shards' slices concatenated along ``dim`` in shard order, on the
    first one's device (a vocab-sharded head's logits; an all-gather over
    ``axes``)."""
    if len(parts) == 1:
        return parts[0]
    home = parts[0].device
    out = torch.cat([p.to(home) for p in parts], dim=dim)
    accounting.collective("all-gather", _nbytes(out), len(parts), axes)
    return out


def broadcast(x: torch.Tensor, devices: Sequence[torch.device]
              ) -> List[torch.Tensor]:
    """``x`` on every device of ``devices`` (the same tensor where it
    already lies)."""
    return [x.to(d) for d in devices]


def psum_quantized(parts: Sequence[torch.Tensor], axes: Sequence[str] = ()
                   ) -> List[torch.Tensor]:
    """The int8-quantized sum, on every position's device: each position's
    max scale (:func:`optim.compress.int8_compress`) is reduced to the
    largest, every part is requantized against that shared scale so the
    sum is coherent, the int32 payloads are summed (exact for fewer than
    2**23 positions) and the sum is scaled back to the parts' type."""
    # imported here: the optimizers import this package's blocked storage
    from repro_torch.optim.compress import int8_compress

    home = parts[0].device
    accounting.collective("all-reduce", 4, len(parts), axes)   # the scale
    scale = torch.stack([int8_compress(p)[1].to(home) for p in parts]).max()
    qs = [torch.clamp(torch.round(p.float() / scale.to(p.device)), -127, 127
                      ).to(torch.int32) for p in parts]
    total = (psum(qs, axes).float() * scale).to(parts[0].dtype)
    return broadcast(total, [p.device for p in parts])


def ring_allreduce(parts: Sequence[torch.Tensor], axes: Sequence[str] = ()
                   ) -> List[torch.Tensor]:
    """The sum of the positions' tensors, on every position's device, as a
    bandwidth-optimal ring: each tensor's leading dim (zero-padded to a
    multiple of ``n``) is cut into ``n`` chunks; ``n - 1`` reduce-scatter
    hops pass each running chunk sum to the next position, which adds its
    own copy, and ``n - 1`` all-gather hops pass the reduced chunks on.
    Every hop is a copy onto the receiving position's device (a real copy
    even where two positions share a device), as the JAX package's
    ``ppermute`` hops are."""
    n = len(parts)
    if n == 1:
        return list(parts)
    devs = [p.device for p in parts]
    lead = parts[0].shape[0]
    pad = (-lead) % n

    def chunks(x: torch.Tensor) -> torch.Tensor:
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        return x.reshape((n, -1) + tuple(x.shape[1:]))

    cs = [chunks(p) for p in parts]

    def hop(xs: List[torch.Tensor]) -> List[torch.Tensor]:
        # position i receives from position i - 1
        accounting.collective("collective-permute", _nbytes(xs[0]), n, axes)
        return [xs[(i - 1) % n].to(devs[i], copy=True) for i in range(n)]

    # reduce-scatter: after hop s position i adds its chunk (i - s - 1)
    acc = [cs[i][i] for i in range(n)]
    for s in range(n - 1):
        acc = [a + cs[i][(i - s - 1) % n] for i, a in enumerate(hop(acc))]
    # position i owns the reduced chunk (i + 1) % n; after k all-gather
    # hops it holds chunk (i + 1 - k) % n
    held = [[a] for a in acc]
    cur = acc
    for _ in range(n - 1):
        cur = hop(cur)
        for i in range(n):
            held[i].append(cur[i])
    out = []
    for i in range(n):
        by_chunk = [held[i][(i + 1 - c) % n] for c in range(n)]
        out.append(torch.cat(by_chunk)[:lead])
    return out


def allreduce_grads_over_pod(grads: Sequence[Any], mesh: Any, *,
                             quantized: bool = True) -> List[Any]:
    """The mean over the ``pod`` axis of gradient trees, one tree per pod
    position: :func:`psum_quantized` divided by the pod count, or the exact
    mean in shard order.  Returns one tree per position."""
    n = mesh.shape["pod"]
    if len(grads) != n:
        raise ValueError(f"{len(grads)} gradient trees for {n} pods")
    flats = [pytree.tree_flatten(g) for g in grads]
    spec = flats[0][1]
    per_pos: List[List[torch.Tensor]] = [[] for _ in range(n)]
    for leaves in zip(*(f[0] for f in flats)):
        if quantized:
            outs = [x / n for x in psum_quantized(leaves, ("pod",))]
        else:
            mean = psum(leaves, ("pod",)) / n
            outs = broadcast(mean, [x.device for x in leaves])
        for i, x in enumerate(outs):
            per_pos[i].append(x)
    return [pytree.tree_unflatten(leaves, spec) for leaves in per_pos]
