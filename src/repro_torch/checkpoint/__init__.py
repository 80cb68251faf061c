from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.serialization import (
    leaf_from_bytes,
    leaf_to_bytes,
    tree_paths,
)

__all__ = ["CheckpointManager", "leaf_from_bytes", "leaf_to_bytes",
           "tree_paths"]
