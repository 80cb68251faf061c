"""Host branch substrate of the port: the lifecycle kernel, the paged-KV
branch manager, the KV tier store, the pytree branch store with its
object-level contexts, and the multi-domain ``branch()`` runtime, copied
from the JAX package's ``repro.core`` (which cannot be imported without
JAX)."""

from repro_torch.core.branch import BranchContext, root_context

from repro_torch.core.errors import (
    BranchError,
    BranchStateError,
    Errno,
    FrozenOriginError,
    NoSuchLeafError,
    PoolExhausted,
    StaleBranchError,
)
from repro_torch.core.kvbranch import AppendSlot, CowOp, KVBranchManager
from repro_torch.core.kvtier import KVSnapshot, KVTierStore
from repro_torch.core.lifecycle import (
    BranchDomain,
    BranchNode,
    BranchStatus,
    BranchTree,
)
from repro_torch.core.runtime_api import (
    BR_ABORT,
    BR_CLOSE_FDS,
    BR_COMMIT,
    BR_CREATE,
    BR_ISOLATE,
    BR_KV,
    BR_STATE,
    BranchHandle,
    BranchRuntime,
)
from repro_torch.core.store import TOMBSTONE, BranchStore, explore

__all__ = [
    "BR_ABORT", "BR_CLOSE_FDS", "BR_COMMIT", "BR_CREATE", "BR_ISOLATE",
    "BR_KV", "BR_STATE", "BranchContext", "BranchHandle", "BranchRuntime",
    "root_context",
    "AppendSlot", "BranchDomain", "BranchError", "BranchNode",
    "BranchStateError", "BranchStatus", "BranchStore", "BranchTree",
    "CowOp", "Errno", "FrozenOriginError", "KVBranchManager", "KVSnapshot",
    "KVTierStore", "NoSuchLeafError", "PoolExhausted", "StaleBranchError",
    "TOMBSTONE", "explore",
]
