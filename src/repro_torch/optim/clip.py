"""Global-norm gradient clipping."""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.utils._pytree as pytree


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in pytree.tree_leaves(tree)))


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return pytree.tree_map(lambda x: (x.float() * scale).to(x.dtype),
                           tree), norm
