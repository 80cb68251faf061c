"""The serving collectives of the port: the sum over tp shards and the
gather along a dimension.

Counterparts of the ``jax.lax.psum`` and ``jax.lax.all_gather(...,
tiled=True)`` that the JAX package's sharded serving steps run inside
``shard_map``.  One host process holds every shard's tensor, so a
collective is a list of tensors in, one tensor out, on shard 0's device:
each partial is copied there (a no-op when it already lies there, a
peer-to-peer copy from another card) and combined in shard order, so a
run is reproducible whatever the layout.  :func:`broadcast` copies the
result back to every shard.  The training-side collectives
(``psum_quantized``, ``ring_allreduce``, ``allreduce_grads_over_pod``)
are not ported yet (ROADMAP §1).
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of the shards' partials, on the first one's device, added
    in shard order."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


def all_gather(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """The shards' slices concatenated along ``dim`` in shard order, on the
    first one's device (a vocab-sharded head's logits)."""
    if len(parts) == 1:
        return parts[0]
    home = parts[0].device
    return torch.cat([p.to(home) for p in parts], dim=dim)


def broadcast(x: torch.Tensor, devices: Sequence[torch.device]
              ) -> List[torch.Tensor]:
    """``x`` on every device of ``devices`` (the same tensor where it
    already lies)."""
    return [x.to(d) for d in devices]
