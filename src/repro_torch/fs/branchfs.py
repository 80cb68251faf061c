"""BranchFS — durable branching delta store (the paper's filesystem, on disk).

The port's copy of ``repro/fs/branchfs.py`` (stdlib host code over the
port's errors and ``Observability``).  It reproduces the BranchFS design
(paper §4) at checkpoint granularity:

* **Branches as delta layers**: each branch is a manifest mapping
  ``path -> chunk id`` (or tombstone).  Unmodified paths resolve through
  the ancestor chain to the base (§4.2).
* **O(1) creation**: creating a branch writes one empty per-branch
  manifest plus the (small) branch-graph file — cost independent of base
  size (paper Table 4; ``chip_smoke.py``'s BranchFS phase times it over
  bases of 10 to 10 000 files).  Deltas are NOT stored in the graph
  file, so a 10k-file base never rewrites on fork.
* **Commit ∝ modification size**: commit merges the delta manifest into
  the parent (tombstones first, §4.3); only delta entries move.  The
  parent's epoch is bumped, invalidating all sibling branches.  Chunk
  payloads are content-addressed and already on disk at write() time, so
  commit itself is O(#modified files) — stronger than the paper's
  O(bytes) file copy (recorded as a beyond-paper delta in EXPERIMENTS).
* **Abort is trivial**: drop the manifest, decref chunks.
* **fsync elision**: branch writes are buffered (no fsync) — durability
  is enforced at commit time, exactly the paper's rationale for beating
  native write throughput on ephemeral branches (§6, Table 6).
* **Unprivileged & portable**: plain files + atomic renames, no mounts,
  no root (R5).
* **@branch paths**: ``read("@feature-a/src/main.py")`` addresses a
  branch's view, mirroring the virtual-directory interface (§4.4).

The in-memory :class:`repro_torch.core.store.BranchStore` and this class
deliberately share semantics; property tests cross-check them against a
single model.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.core.errors import (
    BranchStateError,
    FrozenOriginError,
    NoSuchLeafError,
    StaleBranchError,
)
from repro_torch.fs.chunkstore import ChunkStore
from repro_torch.obs import Observability

_TOMB = "__tombstone__"
BASE = "base"


class BranchFS:
    def __init__(self, root: str | Path, *,
                 obs: Optional[Observability] = None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.chunks = ChunkStore(self.root / "objects")
        self.obs = Observability() if obs is None else obs
        m = self.obs.metrics
        # a CoW fault = first write to a path this branch only inherited
        # (the delta-layer analogue of the KV pool's shared-tail copy)
        self._c_cow_faults = m.counter("fs.cow_faults")
        self._c_writes = m.counter("fs.writes")
        self._c_commits = m.counter("fs.commits")
        self._h_commit_us = m.histogram("fs.commit_us")
        self._g_materialized = m.gauge("fs.chunks_materialized")
        self._lock = threading.RLock()
        self._tree_path = self.root / "tree.json"
        self._log_path = self.root / "tree.log"
        self._log_fd: Optional[int] = None
        self._delta_dir = self.root / "manifests"
        self._delta_dir.mkdir(exist_ok=True)
        self._deltas: Dict[str, Dict[str, str]] = {}
        self._tree = self._load_tree()
        if self._tree is None:
            self._tree = {
                "branches": {
                    BASE: {
                        "parent": None,
                        "status": "active",
                        "epoch": 0,
                        "fork_epoch": 0,
                        "children": [],
                        "delta_id": 0,
                    }
                },
                "next_id": 1,
                "seq": 0,
            }
            self._persist_tree()
            self._persist_delta(BASE)

    # ------------------------------------------------------------------
    # persistence: graph file is O(#branches); manifests are per-branch
    # ------------------------------------------------------------------
    @staticmethod
    def _atomic_write(path: str, data: bytes, durable: bool) -> None:
        """tmp + rename, os-level: this sits on the branch-create hot
        path where pathlib/TextIOWrapper overhead alone is ~40µs."""
        tmp = path + ".tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            os.write(fd, data)
            if durable:
                # durability point: only commits fsync (fsync elision)
                os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)

    def _log(self) -> int:
        if self._log_fd is None:
            self._log_fd = os.open(str(self._log_path),
                                   os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                                   0o644)
        return self._log_fd

    def _load_tree(self) -> Optional[Dict[str, Any]]:
        """Recover the branch graph: compacted ``tree.json`` plus any
        newer full-tree lines journaled since (highest ``seq`` wins; a
        torn final line — crash mid-append — parses as garbage and is
        skipped, falling back to the previous line)."""
        tree: Optional[Dict[str, Any]] = None
        if self._tree_path.exists():
            tree = json.loads(self._tree_path.read_text())
        if self._log_path.exists():
            for line in self._log_path.read_bytes().splitlines():
                try:
                    cand = json.loads(line)
                except ValueError:
                    continue
                if tree is None or cand.get("seq", 0) >= tree.get("seq", 0):
                    tree = cand
        return tree

    def _persist_tree(self, durable: bool = False) -> None:
        """Journal-append (cheap, one ``write(2)`` on an open fd) for
        ephemeral mutations; compact + fsync + truncate the journal at
        durability points.  Branch *creation* therefore costs one log
        append, not a rewrite of the whole graph file — the paper's
        <350µs creation bar with room to spare."""
        self._tree["seq"] = self._tree.get("seq", 0) + 1
        data = json.dumps(self._tree, separators=(",", ":")).encode()
        if not durable:
            os.write(self._log(), data + b"\n")
            return
        # durability point (commit): compacted tree is fsynced first,
        # then the journal is emptied — a crash in between leaves stale
        # log lines whose lower seq loses to the compacted file
        self._atomic_write(str(self._tree_path), data, True)
        os.ftruncate(self._log(), 0)
        os.fsync(self._log_fd)

    def close(self) -> None:
        if self._log_fd is not None:
            try:
                os.close(self._log_fd)
            except OSError:
                pass
            self._log_fd = None

    def __del__(self):   # pragma: no cover - interpreter teardown order
        try:
            self.close()
        # interpreter teardown: module globals (os, json) may already be
        # gone, so even the narrowed close() can fail arbitrarily here
        except Exception:   # branchlint: ignore[BL001]
            pass

    def _delta_path(self, name: str) -> Path:
        return self._delta_dir / f"{self._branch(name)['delta_id']}.json"

    def _delta(self, name: str) -> Dict[str, str]:
        if name not in self._deltas:
            p = self._delta_path(name)
            self._deltas[name] = (json.loads(p.read_text())
                                  if p.exists() else {})
        return self._deltas[name]

    def _persist_delta(self, name: str, durable: bool = False) -> None:
        b = self._branch(name)
        path = self._delta_dir / f"{b['delta_id']}.json"
        if not self._deltas.get(name) and not path.exists():
            # an empty manifest with no file on disk is already its own
            # persisted form (_delta() reads a missing file as {}), so
            # create() costs one tree write, not one file per branch
            return
        self._atomic_write(str(path),
                           json.dumps(self._deltas.get(name, {})).encode(),
                           durable)

    # ------------------------------------------------------------------
    def _branch(self, name: str) -> Dict[str, Any]:
        try:
            return self._tree["branches"][name]
        except KeyError:
            raise BranchStateError(f"unknown branch {name!r}") from None

    def _check_live(self, name: str) -> Dict[str, Any]:
        b = self._branch(name)
        if b["status"] == "stale":
            raise StaleBranchError(f"branch {name} is stale (-ESTALE)")
        if b["status"] != "active":
            raise BranchStateError(f"branch {name} is {b['status']}")
        parent = b["parent"]
        if parent is not None:
            p = self._branch(parent)
            if p["epoch"] != b["fork_epoch"]:
                b["status"] = "stale"
                self._persist_tree()
                raise StaleBranchError(f"branch {name} is stale (-ESTALE)")
        return b

    def _chain(self, name: str) -> Iterator[str]:
        cur: Optional[str] = name
        while cur is not None:
            yield cur
            cur = self._branch(cur)["parent"]

    def _live_children(self, b: Dict[str, Any]) -> List[str]:
        return [
            c
            for c in b["children"]
            if self._tree["branches"][c]["status"] == "active"
        ]

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def create(self, parent: str = BASE, name: Optional[str] = None,
               n: int = 1) -> List[str]:
        """Create ``n`` sibling branches from ``parent``.  O(1) each."""
        with self._lock:
            p = self._branch(parent)
            if p["status"] not in ("active", "committed"):
                raise BranchStateError(f"cannot fork {parent}: {p['status']}")
            names: List[str] = []
            for i in range(n):
                if name is not None and n == 1:
                    bname = name
                else:
                    bname = f"{name or 'b'}{self._tree['next_id']}"
                if bname in self._tree["branches"]:
                    raise BranchStateError(f"branch {bname!r} exists")
                did = self._tree["next_id"]
                self._tree["next_id"] += 1
                self._tree["branches"][bname] = {
                    "parent": parent,
                    "status": "active",
                    "epoch": 0,
                    "fork_epoch": p["epoch"],
                    "children": [],
                    "delta_id": did,
                }
                self._deltas[bname] = {}
                p["children"].append(bname)
                names.append(bname)
                self._persist_delta(bname)
            self._persist_tree()
            return names

    def commit(self, name: str) -> str:
        """Atomic commit-to-parent with first-commit-wins (§4.3)."""
        with self._lock:
            t0 = time.perf_counter_ns()
            b = self._check_live(name)
            if self._live_children(b):
                raise BranchStateError(
                    f"branch {name} has live children; resolve them first"
                )
            parent_name = b["parent"]
            if parent_name is None:
                raise BranchStateError("base branch cannot commit")
            p = self._branch(parent_name)
            delta = self._delta(name)
            pdelta = self._delta(parent_name)
            # tombstones first (deletions), then modifications (§4.3)
            drop: List[str] = []
            for path, cid in delta.items():
                if cid == _TOMB:
                    if p["parent"] is None:
                        old = pdelta.pop(path, None)
                        if old and old != _TOMB:
                            drop.append(old)
                    else:
                        old = pdelta.get(path)
                        if old and old != _TOMB:
                            drop.append(old)
                        pdelta[path] = _TOMB
            for path, cid in delta.items():
                if cid != _TOMB:
                    old = pdelta.get(path)
                    if old and old != _TOMB:
                        drop.append(old)
                    pdelta[path] = cid  # ref transfers child -> parent
            self._deltas[name] = {}
            b["status"] = "committed"
            p["epoch"] += 1  # invalidate siblings
            for sib_name in p["children"]:
                sib = self._tree["branches"][sib_name]
                if sib_name != name and sib["status"] == "active":
                    self._invalidate(sib_name)
            self._persist_delta(name)
            self._persist_delta(parent_name, durable=True)
            self._persist_tree(durable=True)  # the durability point
            if drop:
                self.chunks.decref(drop)
            self._c_commits.inc()
            self._h_commit_us.observe(
                (time.perf_counter_ns() - t0) / 1000.0)
            return parent_name

    def abort(self, name: str) -> None:
        with self._lock:
            b = self._branch(name)
            if b["status"] == "stale":
                return
            if b["status"] != "active":
                raise BranchStateError(f"branch {name} is {b['status']}")
            self._invalidate(name, status="aborted")
            self._persist_tree()

    def _invalidate(self, name: str, status: str = "stale") -> None:
        b = self._tree["branches"][name]
        for child in b["children"]:
            if self._tree["branches"][child]["status"] == "active":
                self._invalidate(child)
        delta = self._delta(name)
        dead = [cid for cid in delta.values() if cid != _TOMB]
        self._deltas[name] = {}
        b["status"] = status
        self._persist_delta(name)
        if dead:
            self.chunks.decref(dead)

    # ------------------------------------------------------------------
    # namespace ops (supports @branch paths, §4.4)
    # ------------------------------------------------------------------
    @staticmethod
    def _split(path: str, default_branch: str) -> Tuple[str, str]:
        if path.startswith("@"):
            branch, _, rest = path[1:].partition("/")
            return branch, rest
        return default_branch, path

    def _inherited(self, branch: str, path: str) -> bool:
        """Whether ``path`` resolves through an ancestor's delta layer."""
        first = True
        for level in self._chain(branch):
            if first:
                first = False
                continue
            delta = self._delta(level)
            if path in delta:
                return delta[path] != _TOMB
        return False

    def write(self, branch: str, path: str, data: bytes) -> None:
        branch, path = self._split(path, branch)
        with self._lock:
            b = self._check_live(branch)
            if self._live_children(b):
                raise FrozenOriginError(f"branch {branch} is frozen")
            delta = self._delta(branch)
            self._c_writes.inc()
            if (path not in delta and b["parent"] is not None
                    and self._inherited(branch, path)):
                # first write to an inherited path: this branch breaks
                # sharing with its ancestors — the FS-layer CoW fault
                self._c_cow_faults.inc()
            cid = self.chunks.put(data)
            self._g_materialized.set(self.chunks.materialized)
            old = delta.get(path)
            delta[path] = cid
            self._persist_delta(branch)  # no fsync: ephemeral until commit
            if old and old != _TOMB:
                self.chunks.decref([old])

    def read(self, branch: str, path: str = "") -> bytes:
        branch, path = self._split(path, branch)
        with self._lock:
            b = self._branch(branch)
            if b["status"] == "active":
                self._check_live(branch)
            elif b["status"] == "stale":
                raise StaleBranchError(f"branch {branch} is stale")
            for level in self._chain(branch):
                delta = self._delta(level)
                if path in delta:
                    cid = delta[path]
                    if cid == _TOMB:
                        raise NoSuchLeafError(path)
                    return self.chunks.get(cid)
            raise NoSuchLeafError(path)

    def delete(self, branch: str, path: str) -> None:
        branch, path = self._split(path, branch)
        with self._lock:
            b = self._check_live(branch)
            if self._live_children(b):
                raise FrozenOriginError(f"branch {branch} is frozen")
            if not self.exists(branch, path):
                raise NoSuchLeafError(path)
            delta = self._delta(branch)
            old = delta.get(path)
            delta[path] = _TOMB
            self._persist_delta(branch)
            if old and old != _TOMB:
                self.chunks.decref([old])

    def exists(self, branch: str, path: str) -> bool:
        try:
            self.read(branch, path)
            return True
        except NoSuchLeafError:
            return False

    def listdir(self, branch: str) -> List[str]:
        with self._lock:
            self._branch(branch)
            seen: Dict[str, bool] = {}
            for level in self._chain(branch):
                for path, cid in self._delta(level).items():
                    if path not in seen:
                        seen[path] = cid != _TOMB
            return sorted(p for p, alive in seen.items() if alive)

    # ------------------------------------------------------------------
    def status(self, branch: str) -> str:
        with self._lock:
            b = self._branch(branch)
            if b["status"] == "active" and b["parent"] is not None:
                p = self._branch(b["parent"])
                if p["epoch"] != b["fork_epoch"]:
                    b["status"] = "stale"
                    self._persist_tree()
            return b["status"]

    def epoch(self, branch: str) -> int:
        return self._branch(branch)["epoch"]

    def delta_paths(self, branch: str) -> List[str]:
        return sorted(self._delta(branch))

    def branches(self) -> List[str]:
        return sorted(self._tree["branches"])
