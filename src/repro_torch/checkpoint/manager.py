"""Branch-aware delta checkpointing on BranchFS — the port's counterpart of
``repro/checkpoint/manager.py``, over the port's own ``repro_torch.fs``,
with the same leaf format, leaf paths, manifest and metadata, so either
package restores a checkpoint the other wrote.

Every checkpoint is a BranchFS branch committed into ``base``:

* **delta economics** — leaves are content-addressed chunks, so a step-N
  checkpoint stores only leaves that changed since step N-1.
* **fsync elision** — leaf writes go to an uncommitted branch; the commit
  is the durability point.
* **async** — ``save_async`` copies the device tensors to the host now
  and writes/commits on a background thread, overlapping serialization
  with the next train step.

A leaf stored as blocks over a mesh (``distributed.blocked.Blocked``) is
written whole, its blocks gathered to the host, so the format does not
depend on the mesh; ``restore`` stores each leaf as ``like``'s leaf is
stored, whole on its device or as its blocks.
"""

from __future__ import annotations

import json
import threading
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from repro_torch.checkpoint.serialization import (
    flatten_with_path,
    leaf_from_bytes,
    leaf_to_bytes,
    map_with_path,
)
from repro_torch.distributed.blocked import block, is_blocked, whole
from repro_torch.fs.branchfs import BASE, BranchFS


def _host(x: Any) -> Any:
    """A leaf on the host, whole (a blocked leaf's blocks gathered)."""
    if is_blocked(x):
        return whole(x, "cpu").detach()
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


class CheckpointManager:
    def __init__(self, root: str | Path, compress: bool = False):
        self.fs = BranchFS(root)
        self.compress = compress
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def _write_tree(self, branch: str, step: int, tree: Any,
                    extra: Optional[Dict[str, Any]] = None) -> None:
        for path, leaf in flatten_with_path(tree):
            self.fs.write(branch, f"step{step:012d}/{path}",
                          leaf_to_bytes(_host(leaf), self.compress))
        meta = {"step": step, "extra": extra or {}}
        self.fs.write(branch, f"step{step:012d}/__meta__",
                      json.dumps(meta).encode())
        self.fs.write(branch, "__latest__", str(step).encode())

    @staticmethod
    def _branch_name(step: int, tag: str) -> str:
        return f"ckpt-{step}-{tag}-{uuid.uuid4().hex[:8]}"

    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Synchronous save: branch → write leaves → commit (durable)."""
        (branch,) = self.fs.create(name=self._branch_name(step, "s"))
        self._write_tree(branch, step, tree, extra)
        self.fs.commit(branch)
        return branch

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        """Copy to the host now; serialize + commit in the background."""
        self.wait()  # one in flight at a time; surfaces prior errors
        host_tree = map_with_path(lambda _, x: _host(x), tree)

        def work():
            try:
                (branch,) = self.fs.create(name=self._branch_name(step,
                                                                  "a"))
                self._write_tree(branch, step, host_tree, extra)
                self.fs.commit(branch)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._worker = threading.Thread(target=work, daemon=True)
        self._worker.start()

    def wait(self) -> None:
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        self.wait()
        try:
            return int(self.fs.read(BASE, "__latest__").decode())
        except KeyError:
            return None

    def restore(self, like: Any, step: Optional[int] = None,
                branch: str = BASE) -> Any:
        """Rebuild a tree shaped like ``like`` from a checkpoint; each
        tensor leaf lands on the device of ``like``'s leaf (as its blocks
        where ``like``'s is stored so), in the stored dtype."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError("no checkpoint committed")

        def load(path: str, old: Any) -> Any:
            leaf = leaf_from_bytes(
                self.fs.read(branch, f"step{step:012d}/{path}"))
            if is_blocked(old):
                return block(leaf, old.sharding)
            return (leaf.to(old.device) if isinstance(old, torch.Tensor)
                    else leaf)
        return map_with_path(load, like)

    def restore_meta(self, step: Optional[int] = None,
                     branch: str = BASE) -> Dict[str, Any]:
        self.wait()
        if step is None:
            step = self.latest_step()
        raw = self.fs.read(branch, f"step{step:012d}/__meta__")
        return json.loads(raw.decode())

    def steps(self) -> List[int]:
        self.wait()
        out = set()
        for p in self.fs.listdir(BASE):
            if p.startswith("step") and p.endswith("/__meta__"):
                out.add(int(p[4:16]))
        return sorted(out)
