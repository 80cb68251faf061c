"""Branch substrate of the port: the lifecycle kernel, the paged-KV
branch manager, the KV tier store, the pytree branch store with its
object-level contexts, the multi-domain ``branch()`` runtime and
device-side N-way exploration (``explore``, over ``torch.func.vmap``),
copied from the JAX package's ``repro.core`` (which cannot be imported
without JAX).  It exports the same names; the store's thread-based
exploration is ``explore_threads``, as there."""

from repro_torch.core.branch import BranchContext, root_context

from repro_torch.core.errors import (
    BranchError,
    BranchStateError,
    FrozenOriginError,
    NoSuchLeafError,
    StaleBranchError,
)
from repro_torch.core.explore import (
    ExploreResult,
    explore,
    first_commit_wins,
    fork_stacked,
    perturbed_fork,
    select_branch,
)
from repro_torch.core.kvbranch import (
    AppendSlot,
    CowOp,
    KVBranchManager,
    SeqStatus,
)
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
from repro_torch.core.store import TOMBSTONE, BranchStore
from repro_torch.core.store import explore as explore_threads

__all__ = [
    "BranchContext", "root_context",
    "BranchDomain", "BranchNode", "BranchTree",
    "BranchError", "BranchStateError", "FrozenOriginError",
    "NoSuchLeafError", "StaleBranchError",
    "ExploreResult", "explore", "explore_threads", "first_commit_wins",
    "fork_stacked", "perturbed_fork", "select_branch",
    "AppendSlot", "CowOp", "KVBranchManager", "SeqStatus",
    "KVSnapshot", "KVTierStore",
    "BR_ABORT", "BR_CLOSE_FDS", "BR_COMMIT", "BR_CREATE", "BR_ISOLATE",
    "BR_KV", "BR_STATE", "BranchHandle", "BranchRuntime",
    "TOMBSTONE", "BranchStatus", "BranchStore",
]
