"""BranchFS analogue on disk — branching delta checkpoints.

The port's copy of the JAX package's ``repro.fs`` (it imports no JAX, but
the port keeps its own).

``chunkstore`` is the content-addressed, refcounted byte store;
``branchfs`` layers branch manifests (delta layers + tombstones + epochs)
with commit-to-parent and sibling invalidation on top, all unprivileged
and portable across underlying filesystems (R5).
"""

from repro_torch.fs.branchfs import BranchFS
from repro_torch.fs.chunkstore import ChunkStore

__all__ = ["BranchFS", "ChunkStore"]
