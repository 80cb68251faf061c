"""Host branch substrate of the port: the lifecycle kernel, the paged-KV
branch manager and the KV tier store, copied from the JAX package's
``repro.core`` (which cannot be imported without JAX)."""

from repro_torch.core.errors import (
    BranchError,
    BranchStateError,
    Errno,
    FrozenOriginError,
    PoolExhausted,
    StaleBranchError,
)
from repro_torch.core.kvbranch import AppendSlot, CowOp, KVBranchManager
from repro_torch.core.kvtier import KVSnapshot, KVTierStore
from repro_torch.core.lifecycle import BranchDomain, BranchNode, BranchTree

__all__ = [
    "AppendSlot", "BranchDomain", "BranchError", "BranchNode",
    "BranchStateError", "BranchTree", "CowOp", "Errno",
    "FrozenOriginError", "KVBranchManager", "KVSnapshot", "KVTierStore",
    "PoolExhausted", "StaleBranchError",
]
