"""Content-addressed, refcounted chunk store.

The port's copy of ``repro/fs/chunkstore.py``.

The durable byte layer under :class:`repro_torch.fs.branchfs.BranchFS`.  Chunks
are immutable blobs addressed by BLAKE2b digest; identical content across
branches/checkpoints is stored once (structural sharing on disk, the same
CoW economics the paper gets from delta directories).  Refcounts are kept
in a sidecar JSON so the store needs nothing beyond ordinary files —
portable across ext4/XFS/NFS/tmpfs and fully unprivileged (R5).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional


def _digest(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=20).hexdigest()


class ChunkStore:
    def __init__(self, root: str | Path):
        self.root = Path(root)
        (self.root / "chunks").mkdir(parents=True, exist_ok=True)
        self._lock = threading.RLock()
        self._refs_path = self.root / "refcounts.json"
        self._refs: Dict[str, int] = {}
        if self._refs_path.exists():
            self._refs = json.loads(self._refs_path.read_text())
        # chunk files actually written (dedup hits don't count); BranchFS
        # mirrors this into its obs gauge `fs.chunks_materialized`
        self.materialized = 0

    def _chunk_path(self, cid: str) -> Path:
        # two-level fanout like .git/objects, keeps directories small
        return self.root / "chunks" / cid[:2] / cid[2:]

    def _persist_refs(self) -> None:
        tmp = self._refs_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self._refs))
        os.replace(tmp, self._refs_path)

    # ------------------------------------------------------------------
    def put(self, data: bytes) -> str:
        """Store ``data``; returns its chunk id.  Incref on every call."""
        cid = _digest(data)
        with self._lock:
            path = self._chunk_path(cid)
            if not path.exists():
                path.parent.mkdir(parents=True, exist_ok=True)
                # atomic create: write to a temp file then rename
                fd, tmp = tempfile.mkstemp(dir=path.parent)
                try:
                    with os.fdopen(fd, "wb") as f:
                        f.write(data)
                    os.replace(tmp, path)
                except BaseException:
                    os.unlink(tmp)
                    raise
                self.materialized += 1
            self._refs[cid] = self._refs.get(cid, 0) + 1
            self._persist_refs()
            return cid

    def get(self, cid: str) -> bytes:
        path = self._chunk_path(cid)
        if not path.exists():
            raise KeyError(f"chunk {cid} not found")
        return path.read_bytes()

    def exists(self, cid: str) -> bool:
        return self._chunk_path(cid).exists()

    def size(self, cid: str) -> int:
        return self._chunk_path(cid).stat().st_size

    def incref(self, cids: Iterable[str]) -> None:
        with self._lock:
            for cid in cids:
                self._refs[cid] = self._refs.get(cid, 0) + 1
            self._persist_refs()

    def decref(self, cids: Iterable[str]) -> None:
        """Drop references; chunks hitting zero are deleted (GC inline)."""
        with self._lock:
            for cid in cids:
                n = self._refs.get(cid, 0) - 1
                if n <= 0:
                    self._refs.pop(cid, None)
                    try:
                        self._chunk_path(cid).unlink()
                    except FileNotFoundError:
                        pass
                else:
                    self._refs[cid] = n
            self._persist_refs()

    def refcount(self, cid: str) -> int:
        return self._refs.get(cid, 0)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "chunks": len(self._refs),
                "bytes": sum(
                    self._chunk_path(c).stat().st_size
                    for c in self._refs
                    if self._chunk_path(c).exists()
                ),
            }
