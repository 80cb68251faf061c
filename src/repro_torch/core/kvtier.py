"""Tiered KV snapshot store — device → host RAM → disk.

The device page pool is the scarcest resource in the system; a held or
parked branch pins its pages for minutes while contributing nothing to
the running batch.  :class:`KVTierStore` holds full-fidelity snapshots
of demoted branches (pages in the pool's *native* dtype, per-page int8
scales when quantized, the block-table shape, and the token tail) so
the engine can hand the device pages back to the allocator and later
restore the branch token-identically.

Tier policy is capacity-driven and transparent to callers:

* **host** — snapshots live as numpy arrays up to ``host_bytes``;
* **disk** — the least-recently-used host snapshot spills to an
  ``.npz`` file when the host tier is over budget, and transparently
  loads back on :meth:`get`.

The store is also a :class:`~repro_torch.core.lifecycle.BranchDomain`: attach
it to the same :class:`BranchTree` as the KV manager and snapshots of
branches that get aborted / invalidated / reaped are dropped in the
same atomic lifecycle transition — a tiered loser of first-commit-wins
cannot leak its snapshot.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.errors import BranchError, Errno
from repro_torch.obs import Observability


@dataclass
class KVSnapshot:
    """Everything needed to re-seat one branch token-identically.

    Pages are stored in the pool's native dtype (bf16 bytes or int8 +
    per-page scales) — re-quantizing on restore would drift tokens.
    Shapes: ``k_pages``/``v_pages`` are ``[layers, n_pages, page_size,
    kv_heads, head_dim]``; scales (int8 pools only) are ``[layers,
    n_pages, kv_heads]``.
    """

    seq_id: int
    length: int
    n_pages: int
    tokens: List[int]
    k_pages: np.ndarray
    v_pages: np.ndarray
    k_scales: Optional[np.ndarray] = None
    v_scales: Optional[np.ndarray] = None
    meta: Dict[str, object] = field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        n = self.k_pages.nbytes + self.v_pages.nbytes
        if self.k_scales is not None:
            n += self.k_scales.nbytes
        if self.v_scales is not None:
            n += self.v_scales.nbytes
        return n


class KVTierStore:
    """Host/disk snapshot tiers for demoted KV branches."""

    def __init__(self, *, host_bytes: int = 64 << 20,
                 disk_dir: Optional[str] = None,
                 obs: Observability = None):
        self.host_bytes = host_bytes
        self._disk_dir = disk_dir
        self._host: Dict[int, KVSnapshot] = {}     # insertion order = LRU
        self._disk: Dict[int, str] = {}            # seq id -> .npz path
        self._disk_bytes: Dict[int, int] = {}
        self.obs = Observability() if obs is None else obs
        m = self.obs.metrics
        self._c_puts = m.counter("tier.demotions")
        self._c_gets = m.counter("tier.restores")
        self._c_spills = m.counter("tier.spills")
        self._c_loads = m.counter("tier.disk_loads")
        self._g_host = m.gauge("tier.host_bytes")
        self._g_disk = m.gauge("tier.disk_bytes")
        self._g_snaps = m.gauge("tier.snapshots")

    # ------------------------------------------------------------------
    # tiers
    # ------------------------------------------------------------------
    def _dir(self) -> str:
        if self._disk_dir is None:
            self._disk_dir = tempfile.mkdtemp(prefix="repro-kvtier-")
        else:
            os.makedirs(self._disk_dir, exist_ok=True)
        return self._disk_dir

    def _host_used(self) -> int:
        return sum(s.nbytes for s in self._host.values())

    def _update_gauges(self) -> None:
        self._g_host.set(self._host_used())
        self._g_disk.set(sum(self._disk_bytes.values()))
        self._g_snaps.set(len(self._host) + len(self._disk))

    def _spill_lru(self) -> None:
        """Move the least-recently-used host snapshot to the disk tier."""
        sid = next(iter(self._host))
        snap = self._host.pop(sid)
        path = os.path.join(self._dir(), f"seq_{sid}.npz")
        arrays = {"k_pages": snap.k_pages, "v_pages": snap.v_pages,
                  "tokens": np.asarray(snap.tokens, dtype=np.int64),
                  "hdr": np.asarray([snap.seq_id, snap.length,
                                     snap.n_pages], dtype=np.int64)}
        if snap.k_scales is not None:
            arrays["k_scales"] = snap.k_scales
            arrays["v_scales"] = snap.v_scales
        np.savez(path, **arrays)
        self._disk[sid] = path
        self._disk_bytes[sid] = os.path.getsize(path)
        self._c_spills.inc()

    def _load(self, sid: int) -> KVSnapshot:
        path = self._disk.pop(sid)
        self._disk_bytes.pop(sid, None)
        with np.load(path) as z:
            hdr = z["hdr"]
            snap = KVSnapshot(
                seq_id=int(hdr[0]), length=int(hdr[1]),
                n_pages=int(hdr[2]), tokens=[int(t) for t in z["tokens"]],
                k_pages=z["k_pages"], v_pages=z["v_pages"],
                k_scales=z["k_scales"] if "k_scales" in z else None,
                v_scales=z["v_scales"] if "v_scales" in z else None)
        try:
            os.remove(path)
        except OSError:
            pass
        self._c_loads.inc()
        return snap

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def put(self, snap: KVSnapshot) -> None:
        """Store a snapshot (host tier; LRU spills to disk over budget)."""
        if snap.seq_id in self._host or snap.seq_id in self._disk:
            raise BranchError(
                f"sequence {snap.seq_id} already has a tiered snapshot "
                "(-EBUSY)", errno=Errno.EBUSY)
        self._host[snap.seq_id] = snap
        self._c_puts.inc()
        # Spill *other* snapshots first (the newcomer is the hottest);
        # a single snapshot bigger than the budget spills itself.
        while self._host_used() > self.host_bytes and len(self._host) > 1:
            self._spill_lru()
        if self._host_used() > self.host_bytes and self._host:
            self._spill_lru()
        self._update_gauges()

    def get(self, seq_id: int) -> KVSnapshot:
        """Fetch a snapshot (loading from disk if spilled); keeps it stored."""
        snap = self._host.pop(seq_id, None)
        if snap is None:
            if seq_id not in self._disk:
                raise BranchError(
                    f"no tiered snapshot for sequence {seq_id} (-ENOENT)",
                    errno=Errno.ENOENT)
            snap = self._load(seq_id)
        self._host[seq_id] = snap          # re-insert = touch (MRU)
        self._c_gets.inc()
        self._update_gauges()
        return snap

    def drop(self, seq_id: int) -> bool:
        """Discard a snapshot; returns whether one existed."""
        had = self._host.pop(seq_id, None) is not None
        path = self._disk.pop(seq_id, None)
        self._disk_bytes.pop(seq_id, None)
        if path is not None:
            had = True
            try:
                os.remove(path)
            except OSError:
                pass
        if had:
            self._update_gauges()
        return had

    def __contains__(self, seq_id: int) -> bool:
        return seq_id in self._host or seq_id in self._disk

    def __len__(self) -> int:
        return len(self._host) + len(self._disk)

    def stats(self) -> Dict[str, int]:
        return {
            "snapshots": len(self),
            "host_snapshots": len(self._host),
            "disk_snapshots": len(self._disk),
            "host_bytes": self._host_used(),
            "disk_bytes": sum(self._disk_bytes.values()),
        }

    # ------------------------------------------------------------------
    # BranchDomain hooks — snapshots die with their branch
    # ------------------------------------------------------------------
    def on_fork(self, parent: int, children: List[int]) -> None:
        pass     # tiered branches cannot fork (kvbranch guards it)

    def on_commit(self, child: int, parent: int) -> None:
        pass     # tiered branches cannot commit (kvbranch guards it)

    def on_abort(self, branch: int) -> None:
        self.drop(branch)

    def on_invalidate(self, branch: int) -> None:
        self.drop(branch)

    def on_reap(self, branch: int) -> None:
        self.drop(branch)


__all__ = ["KVSnapshot", "KVTierStore"]
