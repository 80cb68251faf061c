"""Branched paged KV caches — BR_MEMORY for the accelerator.

The paper's ``BR_MEMORY`` flag branches process memory via page-table
copy-on-write.  The accelerator-resident mutable state of an LLM agent is
its **KV cache** (attention archs) or **recurrent state** (SSM archs), and
the accelerator analogue of page-table CoW is a **block table** over fixed-
size KV pages in HBM:

* pages are the CoW quantum (file ↔ page);
* a fork copies only the block table (O(pages_in_table) ints, no HBM
  traffic) and bumps per-page refcounts — creation cost is independent of
  context length *content* (paper Table 4's O(1)-in-base-size claim,
  measured in ``benchmarks/kvbranch_bench.py``);
* a write to a shared page (appending a token to the tail page) triggers
  CoW: allocate a fresh page, copy one page of KV, update the table;
* commit promotes the child's table to the parent and invalidates
  siblings (their pages are decref'd and recycled) — first-commit-wins;
* nesting falls out of fork-of-fork.

The lifecycle state machine (status, epochs, first-commit-wins CAS,
frozen origins, sibling invalidation) lives in the shared kernel,
:class:`~repro_torch.core.lifecycle.BranchTree`; this class is the BR_MEMORY
payload domain plugged into it (DESIGN §2).  It owns only block tables,
refcounts and the free list, moved by the ``on_fork/on_commit/on_abort/
on_invalidate`` hooks.  Additional domains (e.g. the serving engine's
token tails) may attach to the *same* tree, so one ``commit(seq)``
atomically resolves every domain keyed by that sequence id.

Host metadata (tables, refcounts, free list) lives here; the page buffers
themselves are device tensors owned by the serving engine
(:mod:`repro_torch.runtime.serve_loop`), updated in place by its step.
"""

from __future__ import annotations

import hashlib
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.errors import (
    BranchError,
    BranchStateError,
    Errno,
    FrozenOriginError,
    PoolExhausted,
)
from repro_torch.core.lifecycle import LIVE, BranchStatus, BranchTree
from repro_torch.obs import Observability

# Historical alias: sequence status *is* branch status now that every
# domain shares the kernel's vocabulary.
SeqStatus = BranchStatus


@dataclass(frozen=True)
class CowOp:
    """A device-side page copy the caller must perform before appending."""

    src_page: int
    dst_page: int


@dataclass(frozen=True)
class AppendSlot:
    """Where the next token's KV goes for one sequence."""

    page: int
    offset: int
    cow: Tuple[CowOp, ...] = ()


class KVBranchManager:
    """Block tables + refcounts plugged into the branch-lifecycle kernel."""

    def __init__(self, num_pages: int, page_size: int, *,
                 obs: Observability = None):
        if num_pages < 1 or page_size < 1:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._refcount = np.zeros((num_pages,), dtype=np.int32)
        self.obs = Observability() if obs is None else obs
        m = self.obs.metrics
        self._c_forks = m.counter("kv.branches_forked")
        self._c_commits = m.counter("kv.commits")
        self._c_aborts = m.counter("kv.aborts")
        self._c_invalidations = m.counter("kv.invalidations")
        self._c_prefix_hits = m.counter("kv.prefix_hits")
        self._c_prefix_misses = m.counter("kv.prefix_misses")
        self._c_prefix_evictions = m.counter("kv.prefix_evictions")
        self._g_free = m.gauge("kv.pages_free")
        self._g_free.set(num_pages)
        self._g_shared = m.gauge("kv.pages_shared")
        self._g_util = m.gauge("kv.pool_utilization")
        self._g_prefix_shared = m.gauge("kv.prefix_pages_shared")
        self._g_tiered = m.gauge("kv.pages_tiered")
        # incremental shared-page count (refcount 1<->2 crossings), so
        # the gauge never pays the O(num_pages) scan stats() does
        self._shared_pages = 0
        self._invalidated_once: set = set()
        # KV semantics: forking freezes the origin (appends denied) until
        # all children resolve; committed sequences are gone for good.
        self._tree = BranchTree(freeze_on_fork=True,
                                allow_fork_resolved=False,
                                tracer=self.obs.tracer)
        self._tree.attach(self)
        self._tables: Dict[int, List[int]] = {}
        self._lengths: Dict[int, int] = {}
        # Cross-request prefix cache: chained content hash of a prompt's
        # page-aligned token runs -> the page already holding that KV
        # (the gitstore idiom: content addresses, not positions).  Each
        # entry holds ONE page reference of its own, so a registered
        # page survives the request that wrote it and any later append
        # by an adopter CoWs away from it.  Evicted LRU-first when the
        # free list runs dry — the cache is reclaimable, never a
        # commitment.
        self._prefix_pages: Dict[str, int] = {}
        self._prefix_lru: Dict[str, int] = {}
        self._prefix_tick = 0
        # Tiered (demoted) branches: still live in the lifecycle tree,
        # but their pages were checkpointed out of the device pool (the
        # snapshot lives in a KVTierStore).  Maps seq id -> page count
        # needed to promote it back.
        self._tiered_pages: Dict[int, int] = {}

    @property
    def tree(self) -> BranchTree:
        """The lifecycle kernel; other domains (token tails, executor
        slots) attach here to resolve atomically with the KV domain."""
        return self._tree

    # ------------------------------------------------------------------
    # page accounting
    # ------------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return int(self._refcount[page])

    def _alloc_page(self) -> int:
        if not self._free:
            # Reclaim before refusing: prefix-cache pages whose only
            # remaining reference is the cache's own are recyclable.
            self._evict_prefixes()
        if not self._free:
            raise PoolExhausted("KV page pool exhausted (-ENOSPC)")
        page = self._free.pop()
        self._refcount[page] = 1
        self._update_pool_gauges()
        return page

    def _evict_prefixes(self) -> None:
        """Drop LRU prefix-cache entries until a page frees (or none left).

        Dropping an entry releases the cache's reference; the page only
        actually returns to the free list if no live table still shares
        it — entries still backing live sequences are cheap to drop and
        re-register, so LRU order need not care.
        """
        while self._prefix_pages and not self._free:
            key = min(self._prefix_lru, key=self._prefix_lru.__getitem__)
            page = self._prefix_pages.pop(key)
            del self._prefix_lru[key]
            self._c_prefix_evictions.inc()
            self._decref([page])
        self._g_prefix_shared.set(len(self._prefix_pages))

    def _update_pool_gauges(self) -> None:
        free = len(self._free)
        self._g_free.set(free)
        self._g_util.set(round(1.0 - free / self.num_pages, 4))

    def _incref(self, pages: Sequence[int]) -> None:
        for p in pages:
            self._refcount[p] += 1
            if self._refcount[p] == 2:
                self._shared_pages += 1
        if pages:
            self._g_shared.set(self._shared_pages)

    def _decref(self, pages: Sequence[int]) -> None:
        # Validate EVERY release before mutating anything: a double
        # release must fail with the allocator untouched.  The old guard
        # was a bare assert placed *after* the page had already
        # re-entered the free list — under ``python -O`` the assert
        # vanished and a doubly-freed page could be handed to two live
        # sequences.  Occurrence-aware: a page appearing k times in
        # ``pages`` needs k outstanding references.
        if len(pages) == 1:     # hot path (CoW faults, tail trims)
            occurrences = {pages[0]: 1} if self._refcount[pages[0]] < 1 \
                else {}
        else:
            occurrences = Counter(pages)
        for p, k in occurrences.items():
            have = int(self._refcount[p])
            if have < k:
                raise BranchError(
                    f"double release of page {p}: {k} release(s) "
                    f"requested but refcount is {have}; tables and free "
                    "list left untouched (-EINVAL)", errno=Errno.EINVAL)
        freed = False
        for p in pages:
            self._refcount[p] -= 1
            if self._refcount[p] == 1:
                self._shared_pages -= 1
            elif self._refcount[p] == 0:
                self._free.append(p)
                freed = True
        if pages:
            self._g_shared.set(self._shared_pages)
            if freed:
                self._update_pool_gauges()

    # ------------------------------------------------------------------
    # BranchDomain payload hooks (called by the kernel, under its lock)
    # ------------------------------------------------------------------
    def on_fork(self, parent: int, children: List[int]) -> None:
        table = self._tables[parent]
        for c in children:
            self._incref(table)
            self._tables[c] = list(table)
            self._lengths[c] = self._lengths[parent]
        self._c_forks.inc(len(children))

    def on_commit(self, child: int, parent: int) -> None:
        # The parent adopts the child's table, *transferring* the child's
        # page references (no incref/decref on the winning table).
        self._decref(self._tables[parent])
        self._tables[parent] = self._tables[child]
        self._lengths[parent] = self._lengths[child]
        self._tables[child] = []
        self._c_commits.inc()

    def on_abort(self, branch: int) -> None:
        self._release_pages(branch)
        self._c_aborts.inc()

    def on_invalidate(self, branch: int) -> None:
        # idempotent hook (abort-after-ESTALE re-fires it); count each
        # branch's invalidation once
        if branch not in self._invalidated_once:
            self._invalidated_once.add(branch)
            self._c_invalidations.inc()
        self._release_pages(branch)

    def on_reap(self, branch: int) -> None:
        # The kernel forgot this id: drop the payload *entries*, not just
        # their contents (host memory must not grow with request count).
        table = self._tables.pop(branch, None)
        if table:
            self._decref(table)
        self._lengths.pop(branch, None)
        self._invalidated_once.discard(branch)
        self._drop_tiered(branch)

    def _release_pages(self, branch: int) -> None:
        table = self._tables.get(branch)
        if table:
            self._decref(table)
        self._tables[branch] = []
        self._drop_tiered(branch)

    def _drop_tiered(self, branch: int) -> None:
        if self._tiered_pages.pop(branch, None) is not None:
            self._g_tiered.set(sum(self._tiered_pages.values()))

    # ------------------------------------------------------------------
    # sequence lifecycle (delegated to the kernel)
    # ------------------------------------------------------------------
    def is_live(self, seq_id: int) -> bool:
        return self._tree.is_live(seq_id)

    def status(self, seq_id: int) -> BranchStatus:
        return self._tree.status(seq_id)

    def new_seq(self, length: int = 0, *,
                prefix_pages: Optional[Sequence[int]] = None) -> int:
        """Create a root sequence with enough pages for ``length`` tokens.

        ``prefix_pages`` (from :meth:`match_prefix`) seeds the head of
        the block table with shared, CoW-protected pages — each gains a
        reference here, atomically with the fresh-tail allocation.  The
        call is transactional: pool exhaustion mid-allocation releases
        everything taken so far and re-raises, mutating nothing.
        """
        with self._tree.lock:
            n_pages = -(-max(length, 0) // self.page_size)
            shared = list(prefix_pages or ())
            if len(shared) > n_pages:
                raise BranchError(
                    f"{len(shared)} prefix pages exceed the {n_pages}-page "
                    f"table for {length} tokens (-EINVAL)",
                    errno=Errno.EINVAL)
            self._incref(shared)
            fresh: List[int] = []
            try:
                for _ in range(n_pages - len(shared)):
                    fresh.append(self._alloc_page())
            except PoolExhausted:
                self._decref(fresh)
                self._decref(shared)
                raise
            sid = self._tree.create_root()
            self._tables[sid] = shared + fresh
            self._lengths[sid] = length
            return sid

    # ------------------------------------------------------------------
    # cross-request prefix sharing (content-addressed page runs)
    # ------------------------------------------------------------------
    def _prefix_keys(self, tokens: Sequence[int]) -> List[str]:
        """Chained content key per FULL page of ``tokens``.

        Chained (each page's key folds in every preceding page) so a
        page is only shareable when the *entire* prefix up to it
        matches — position-independent content addressing would alias
        different contexts onto one KV page.
        """
        keys: List[str] = []
        h = hashlib.sha1()
        ps = self.page_size
        for i in range(len(tokens) // ps):
            h.update(np.asarray(tokens[i * ps:(i + 1) * ps],
                                dtype=np.int64).tobytes())
            keys.append(h.hexdigest())
        return keys

    def _tail_key(self, tokens: Sequence[int]) -> Optional[str]:
        """Key for a partially-filled tail page, or ``None`` if aligned.

        Keyed on the whole prefix *and* its exact length, so a cached
        tail only ever matches a byte-identical full prompt — partial
        tail pages contain fewer valid tokens than their page claims,
        and sharing them on anything less than an exact match would
        serve garbage KV.
        """
        tail = len(tokens) % self.page_size
        if tail == 0:
            return None
        h = hashlib.sha1()
        h.update(np.asarray(tokens, dtype=np.int64).tobytes())
        return f"tail:{len(tokens)}:{h.hexdigest()}"

    def match_prefix(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached run of shared pages covering a prefix of ``tokens``.

        Returns ``(pages, covered_tokens)``.  Full pages match from page
        0 outward; a cached partial tail page additionally matches only
        when it completes an *exact* whole-prompt hit (then ``covered ==
        len(tokens)`` and the adopter needs no prefill at all).  The
        returned pages are not referenced yet — adopt them atomically
        via ``new_seq(length, prefix_pages=pages)``.
        """
        with self._tree.lock:
            pages: List[int] = []
            keys = self._prefix_keys(tokens)
            for key in keys:
                page = self._prefix_pages.get(key)
                if page is None:
                    break
                self._prefix_tick += 1
                self._prefix_lru[key] = self._prefix_tick
                pages.append(page)
            covered = len(pages) * self.page_size
            if len(pages) == len(keys) and covered < len(tokens):
                tkey = self._tail_key(tokens)
                page = None if tkey is None else self._prefix_pages.get(tkey)
                if page is not None:
                    self._prefix_tick += 1
                    self._prefix_lru[tkey] = self._prefix_tick
                    pages.append(page)
                    covered = len(tokens)
            if covered:
                self._c_prefix_hits.inc()
            else:
                self._c_prefix_misses.inc()
            return pages, covered

    def register_prefix(self, seq_id: int, tokens: Sequence[int]) -> int:
        """Publish ``seq_id``'s prompt pages for cross-request sharing.

        ``tokens`` must be the prompt whose KV currently fills the head
        of ``seq_id``'s block table.  Every not-yet-cached full page —
        plus the partial tail page, under its exact-match-only key —
        gains one cache-owned reference.  Returns the number of pages
        newly registered.  Registering a page that later CoWs away from
        its writer is fine: the cache's copy keeps the original bytes.
        """
        with self._tree.lock:
            self._tree.node(seq_id)
            table = self._tables[seq_id]
            added = 0

            def _put(key: str, page: int) -> None:
                self._incref([page])
                self._prefix_pages[key] = page
                self._prefix_tick += 1
                self._prefix_lru[key] = self._prefix_tick

            keys = self._prefix_keys(tokens)
            for i, key in enumerate(keys):
                if key in self._prefix_pages or i >= len(table):
                    continue
                _put(key, table[i])
                added += 1
            tkey = self._tail_key(tokens)
            if (tkey is not None and tkey not in self._prefix_pages
                    and len(table) > len(keys)):
                _put(tkey, table[len(keys)])
                added += 1
            if added:
                self._g_prefix_shared.set(len(self._prefix_pages))
            return added

    def prefix_cache_size(self) -> int:
        return len(self._prefix_pages)

    def length(self, seq_id: int) -> int:
        self._tree.node(seq_id)
        return self._lengths[seq_id]

    def block_table(self, seq_id: int) -> List[int]:
        self._tree.node(seq_id)
        return list(self._tables[seq_id])

    # ------------------------------------------------------------------
    # fork / append(CoW) / commit / abort
    # ------------------------------------------------------------------
    def fork(self, seq_id: int, n: int = 1) -> List[int]:
        """Fork ``n`` children sharing every page of the parent.

        O(table length) integer work, zero HBM traffic; the parent becomes
        a frozen origin until all children resolve.
        """
        with self._tree.lock:
            self._check_not_tiered(seq_id)
            return self._tree.fork(seq_id, n)

    def fork_batch(self, seq_id: int,
                   n: int = 1) -> Tuple[List[int], List[CowOp]]:
        """Vectorized fork: ``n`` siblings plus their fused tail CoW plan.

        The TClone-style hot path for agent fan-out: all ``n`` children
        are created in one kernel transaction (one lock, one exclusive
        commit group), and the shared-tail copy-on-write every child
        would otherwise fault individually at its first append is
        resolved *eagerly* — each child's table tail is swapped to a
        freshly allocated page here, and the page copies are returned as
        one :class:`CowOp` list the caller services in a **single**
        fused ``_copy_pages`` device dispatch.  ``n`` sequential
        ``fork(seq, 1)`` calls pay ``n`` dispatches for the same state.

        Only the partially-filled tail page is pre-faulted (a full tail
        means the next append opens a fresh page — no CoW to hoist).  If
        the pool empties mid-plan the remaining children simply keep the
        shared tail and fault lazily later; eager CoW is an optimization,
        never a correctness requirement.  (In the JAX package the
        scheduler's fork admission reserves one CoW'd tail page per
        child, so callers going through it cannot hit that path.)
        """
        with self._tree.lock:
            self._check_not_tiered(seq_id)
            children = self._tree.fork(seq_id, n)
            ops: List[CowOp] = []
            table = self._tables[seq_id]
            if table and self._lengths[seq_id] % self.page_size != 0:
                shared = table[-1]
                for c in children:
                    child_table = self._tables[c]
                    if self._refcount[shared] <= 1 or \
                            not child_table or child_table[-1] != shared:
                        continue
                    try:
                        fresh = self._alloc_page()
                    except PoolExhausted:
                        break   # remaining children CoW lazily on append
                    self._decref([shared])
                    child_table[-1] = fresh
                    ops.append(CowOp(src_page=shared, dst_page=fresh))
            return children, ops

    def prepare_append(self, seq_id: int, n_tokens: int = 1) -> List[AppendSlot]:
        """Reserve slots for the next ``n_tokens`` tokens of ``seq_id``.

        Returns one :class:`AppendSlot` per token; any CoW page copies the
        device must perform are attached to the slot that triggers them.
        The block table and length are updated eagerly (metadata is the
        source of truth; device writes follow).
        """
        with self._tree.lock:
            node = self._tree.check_live(seq_id)
            if node.status is BranchStatus.FROZEN:
                raise FrozenOriginError(
                    f"sequence {seq_id} has live children and is frozen")
            self._check_not_tiered(seq_id)
            table = self._tables[seq_id]
            slots: List[AppendSlot] = []
            try:
                for _ in range(n_tokens):
                    offset = self._lengths[seq_id] % self.page_size
                    cow: Tuple[CowOp, ...] = ()
                    if offset == 0:
                        # new page needed
                        page = self._alloc_page()
                        table.append(page)
                    else:
                        page = table[-1]
                        if self._refcount[page] > 1:
                            # shared tail page: copy-on-write
                            new_page = self._alloc_page()
                            cow = (CowOp(src_page=page, dst_page=new_page),)
                            self._decref([page])
                            table[-1] = new_page
                            page = new_page
                    self._lengths[seq_id] += 1
                    slots.append(AppendSlot(page=page, offset=offset,
                                            cow=cow))
            except MemoryError:
                # -ENOSPC midway: earlier tokens of this call mutated the
                # table/length — undo them so the caller sees all or
                # nothing (length == tokens - 1 stays intact).
                self._undo_slots(seq_id, slots)
                raise
            return slots

    def _undo_slots(self, seq_id: int, slots: Sequence[AppendSlot]) -> None:
        """Reverse the metadata mutations of reserved-but-unused slots.

        Only legal before any device write consumed the slots: CoW page
        copies and KV writes happen strictly after slot reservation, so
        rolling back tables/lengths/refcounts here leaves no device state
        referencing the undone pages.
        """
        table = self._tables[seq_id]
        for slot in reversed(slots):
            self._lengths[seq_id] -= 1
            if slot.cow:
                (op,) = slot.cow
                self._incref([op.src_page])
                self._decref([op.dst_page])   # freshly allocated -> freed
                table[-1] = op.src_page
            elif slot.offset == 0:
                table.pop()
                self._decref([slot.page])

    def prepare_append_batch(
        self, seq_ids: Sequence[int], n_tokens: int = 1
    ) -> List[List[AppendSlot]]:
        """All-or-nothing slot reservation across a decode batch.

        Either every sequence gets its slots or *no* metadata is mutated:
        if the pool exhausts (or a sequence turns out frozen/stale) after
        earlier batch members were prepared, their mutations — including
        speculative CoW tail-page swaps whose device copy has not run —
        are rolled back before the error propagates.  This turns a
        mid-batch -ENOSPC into a clean, retryable -EAGAIN instead of
        silent KV corruption of earlier batch members.
        """
        with self._tree.lock:
            done: List[Tuple[int, List[AppendSlot]]] = []
            try:
                for sid in seq_ids:
                    done.append((sid, self.prepare_append(sid, n_tokens)))
            except Exception:
                for sid, slots in reversed(done):
                    self._undo_slots(sid, slots)
                raise
            return [slots for _, slots in done]

    def truncate(self, seq_id: int, new_length: int) -> None:
        """Shrink a sequence to ``new_length`` cached tokens.

        The speculative-decoding primitive: a draft branch whose suffix
        failed verification keeps only its verified prefix.  Surplus
        tail pages are decref'd (a page still shared with the fork
        origin simply drops this branch's reference); retained pages are
        untouched, and any stale KV beyond ``new_length`` in a partially
        filled tail page is never read (attention is bounded by the
        length) and is overwritten by later appends.
        """
        with self._tree.lock:
            node = self._tree.check_live(seq_id)
            if node.status is BranchStatus.FROZEN:
                raise FrozenOriginError(
                    f"sequence {seq_id} has live children and is frozen")
            self._check_not_tiered(seq_id)
            if new_length < 0 or new_length > self._lengths[seq_id]:
                raise ValueError(
                    f"cannot truncate sequence {seq_id} from "
                    f"{self._lengths[seq_id]} to {new_length} tokens")
            table = self._tables[seq_id]
            keep = -(-new_length // self.page_size)
            if keep < len(table):
                self._decref(table[keep:])
                del table[keep:]
            self._lengths[seq_id] = new_length

    def commit(self, seq_id: int) -> int:
        """First-commit-wins: promote this child's table into the parent.

        Siblings turn STALE and their page references are recycled.
        Returns the parent sequence id (which resumes ACTIVE with the
        child's content, PID-takeover style).
        """
        with self._tree.lock:
            # A tiered child has an empty table; committing it would
            # strip the parent's pages and adopt nothing.
            self._check_not_tiered(seq_id)
            return self._tree.commit(seq_id)

    def abort(self, seq_id: int) -> None:
        """Discard the branch; siblings stay valid; parent may resume."""
        self._tree.abort(seq_id)

    def release(self, seq_id: int) -> None:
        """Free a root/active sequence outright (serving-slot eviction).

        The subtree is invalidated and then *reaped*: lifecycle nodes and
        payload entries (tables, lengths, attached-domain dicts) are
        dropped, so a long-running serving loop does not accumulate host
        state for retired requests.
        """
        with self._tree.lock:
            self._tree.invalidate(seq_id, status=BranchStatus.ABORTED)
            self._tree.reap(seq_id)

    # ------------------------------------------------------------------
    # tiering (device -> host/disk demotion, BR_TIERED)
    # ------------------------------------------------------------------
    def _check_not_tiered(self, seq_id: int) -> None:
        if seq_id in self._tiered_pages:
            raise BranchError(
                f"sequence {seq_id} is tiered out (pages checkpointed to "
                "a lower tier); restore it before operating on its KV "
                "(-EAGAIN)", errno=Errno.EAGAIN)

    def is_tiered(self, seq_id: int) -> bool:
        return seq_id in self._tiered_pages

    def demote(self, seq_id: int) -> List[int]:
        """Release a live branch's device pages for tiering.

        The branch stays live in the lifecycle tree (its length and
        node survive; first-commit-wins semantics are untouched) but its
        block table is emptied and every page reference dropped — the
        caller must have snapshotted the page contents first (the
        engine's ``checkpoint`` does).  Returns the old table so the
        caller can gather pages *before* calling, or audit after.
        """
        with self._tree.lock:
            self._tree.check_live(seq_id)
            if seq_id in self._tiered_pages:
                raise BranchStateError(f"sequence {seq_id} is already tiered")
            if self._tree.has_live_children(seq_id):
                raise BranchError(
                    f"sequence {seq_id} has live children sharing its "
                    "pages; demote the leaves instead (-EBUSY)",
                    errno=Errno.EBUSY)
            table = self._tables[seq_id]
            pages = list(table)
            self._decref(table)
            self._tables[seq_id] = []
            self._tiered_pages[seq_id] = len(pages)
            self._g_tiered.set(sum(self._tiered_pages.values()))
            return pages

    def promote(self, seq_id: int) -> List[int]:
        """Re-seat a tiered branch: allocate a fresh block table.

        Transactional — pool exhaustion mid-allocation frees everything
        taken and re-raises with the branch still tiered, so the caller
        can demote something else and retry.  The caller scatters the
        snapshot back into the returned pages.
        """
        with self._tree.lock:
            self._tree.check_live(seq_id)
            if seq_id not in self._tiered_pages:
                raise BranchStateError(f"sequence {seq_id} is not tiered")
            fresh: List[int] = []
            try:
                for _ in range(self._tiered_pages[seq_id]):
                    fresh.append(self._alloc_page())
            except PoolExhausted:
                self._decref(fresh)
                raise
            self._tables[seq_id] = fresh
            del self._tiered_pages[seq_id]
            self._g_tiered.set(sum(self._tiered_pages.values()))
            return fresh

    # ------------------------------------------------------------------
    # dense views for the device step
    # ------------------------------------------------------------------
    def dense_block_tables(
        self, seq_ids: Sequence[int], max_pages: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Pack block tables into ``[batch, max_pages]`` (pad = 0) plus
        lengths ``[batch]`` for the paged-attention kernel."""
        bt = np.zeros((len(seq_ids), max_pages), dtype=np.int32)
        lens = np.zeros((len(seq_ids),), dtype=np.int32)
        for i, sid in enumerate(seq_ids):
            self._tree.node(sid)
            self._check_not_tiered(sid)
            table = self._tables[sid]
            if len(table) > max_pages:
                raise ValueError(
                    f"sequence {sid} needs {len(table)} pages > {max_pages}"
                )
            bt[i, : len(table)] = table
            lens[i] = self._lengths[sid]
        return bt, lens

    def footprints(self) -> Dict[int, int]:
        """Per-branch page footprint (pages referenced by each live
        branch's table) — the per-tenant accounting view."""
        with self._tree.lock:
            return {sid: len(table) for sid, table in self._tables.items()
                    if sid in self._tree
                    and self._tree.node(sid).status in LIVE}

    def stats(self) -> Dict[str, int]:
        return {
            "sequences_live": self._tree.live_count(),
            "pages_total": self.num_pages,
            "pages_free": len(self._free),
            "pages_shared": int((self._refcount > 1).sum()),
            "prefix_pages_cached": len(self._prefix_pages),
            "sequences_tiered": len(self._tiered_pages),
            "pages_tiered": sum(self._tiered_pages.values()),
        }


__all__ = [
    "AppendSlot",
    "CowOp",
    "KVBranchManager",
    "SeqStatus",
]
