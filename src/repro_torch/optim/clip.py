"""Global-norm gradient clipping.  A leaf stored as blocks on several
cards contributes its blocks' squares: each block's sum lies on its own
device, and the sums are added on the first one's in leaf order."""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.utils._pytree as pytree


def global_norm(tree: Any) -> torch.Tensor:
    """On the first leaf's device."""
    sq = [torch.sum(torch.square(x.float()))
          for x in pytree.tree_leaves(tree)]
    return torch.sqrt(sum(x.to(sq[0].device) for x in sq))


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return pytree.tree_map(
        lambda x: (x.float() * scale.to(x.device)).to(x.dtype), tree), norm
