"""ServeEngine — branchable paged-KV serving on CUDA devices.

The PyTorch counterpart of ``repro/runtime/serve_loop.py``:

* KV lives in fixed-size **pages** (``[L, n_pages, page, kv, hd]`` pools);
  sequences hold block tables managed by :class:`KVBranchManager`.
* ``fork(seq, n)`` creates N branches sharing every page (CoW); the first
  append to a shared tail page is a CoW fault.
* ``decode`` runs one fused step per token: every pending CoW fault of the
  batch arrives as a (src, dst) vector, attention reads the *pre-copy*
  pool through ``page_map`` (a faulted dst reads its src) with the fresh
  token's K/V inline, and only then are the page copies and the token's
  slot write applied, layer by layer.  On one shard of a card, a batch of
  up to ``DECODE_RUNGS[-1]`` rows replays that step as a CUDA graph
  captured at the smallest rung of the ladder that holds it (see
  :class:`_DecodeRung`).
* ``attn_impl="ref"`` keeps the legacy two-dispatch step instead: the
  step's CoW faults are serviced first as one batched page copy (counted
  in ``cow_dispatches``), then per layer the token's K/V is written into
  its slot and cached-only attention reads ``lengths + 1`` positions.
* ``spec_verify`` scores k draft tokens per row in one pass over a shared
  block table; a prefix-cache hit prefills only the uncovered suffix.
* ``commit`` resolves first-commit-wins; ``checkpoint``/``restore`` move a
  branch's pages to the host tier and back.
* ``kv_dtype="int8"`` stores int8 pools with per-page/per-kv-head scales.
* It serves the dense and MoE families and the VLM stub's text path (no
  image: ``add_request`` takes tokens only, as in the JAX engine), with any
  of the three MLPs; an MoE layer routes every row of a pass together, as
  the JAX engine's ``_ffn`` does.  Several codebooks (audio), the SSM and
  the hybrid family are refused at construction.

**Tensor-parallel serving** (the JAX package's DESIGN §11): ``tp=`` or
``mesh=`` splits the passes over ``tp`` shards, one host process driving
all of them.  Weights shard by the training rules retargeted to the tp
axis (heads, kv heads, d_ff, experts; vocab for an untied head), the pools
shard on the **kv-head dim** (a page id means the same on every shard),
and every pass runs each layer's shard-local work on every shard's device
(launches are asynchronous, so shards on different cards overlap), then
sums the two partial results a layer (attention output over heads, the
MLP or MoE down-projection) on shard 0 in shard order and gathers a
vocab-sharded head's logits there (``distributed.collectives``).  Block
tables, refcounts, the lifecycle tree and token tails exist once on the
host, so fork/commit cost does not change with ``tp``.  ``tp=N`` with
``device="cpu"`` or a card with an index puts every shard there (the
tests, and a one-card run); without a device, or with ``"cuda"``, it takes
the first ``N`` cards and raises when fewer are visible.  Unset, the
engine is one shard holding the whole model on ``device``.  ``params`` is
the whole tree (cut into the shards here) or a list of one tree per shard
already on its device (``Model.init(generator, shards=plan)``, for a model
no one device holds), checked against the serving specs and taken as it
is.

Attention is :func:`repro_torch.kernels.paged_attention.
paged_chunk_attention` (fused decode, verify, suffix prefill — on both
paths), :func:`repro_torch.kernels.paged_attention.paged_attention` (the
legacy decode step) and, in the dense prefill,
:func:`repro_torch.kernels.flash_attention.flash_attention`: hand-written
CUDA kernels on the card, at each shard's head count; their plain versions
for CPU tensors.  The dense prefill is the engine's own shard-local pass
(the JAX engine calls ``Model.prefill`` on sharded parameters and leaves
the split to XLA); it is the model's prefill at one shard.  Its attention
sublayer, every pass's FFN and the gathered head are the shard-local
passes of :mod:`repro_torch.models.sharded`, which the training forward
over a mesh runs too.

Unlike the JAX engine, which returns new pool arrays from every jitted
step, this engine **updates its pools in place** (indexed writes into
each shard's ``k_pages``/``v_pages`` and scales).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import KVBranchManager
from repro_torch.core.kvtier import KVSnapshot, KVTierStore
from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import broadcast
from repro_torch.distributed.mesh import (
    DeviceMesh,
    ParallelPlan,
    serving_plan,
    tp_mesh,
)
from repro_torch.distributed.sharding import (
    check_shards,
    kv_split,
    serve_specs,
    shard_params,
)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import (
    paged_attention,
    paged_chunk_attention,
)
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import layers as L
from repro_torch.models import sharded
from repro_torch.models.model import Model
from repro_torch.models.transformer import (
    check_engine_servable,
    embed_tokens,
    lm_head,
    torch_dtype,
)
from repro_torch.obs import ENGINE_TRACK, Observability
from repro_torch.obs.tracer import NO_SPAN

Pools = List[Optional[torch.Tensor]]   # [k_pages, v_pages, k_scales, v_scales]

#: the batch sizes the fused decode step is captured at, one CUDA graph a
#: rung: a step of ``b`` rows runs the smallest rung ``>= b``, its rows
#: past ``b`` padding; a larger batch runs the eager step
DECODE_RUNGS = (1, 2, 4, 8) + tuple(range(16, 129, 8))

#: the kernel wrappers' launch counters: a decode graph's capture calls the
#: wrappers but launches nothing, so its counts are taken back; each replay
#: launches what the capture counted, so it adds them again
_LAUNCH_COUNTERS = (paged_ops.LAUNCHES, flash_ops.LAUNCHES)


def params_to(params: Any, device: torch.device) -> Any:
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)


# ---------------------------------------------------------------------------
# pool maintenance (in place)
# ---------------------------------------------------------------------------

def _quant_token_write(pages: torch.Tensor,      # [n_pages, page, kv, hd] int8
                       scales: torch.Tensor,     # [n_pages, kv] f32
                       slot_pages: torch.Tensor,    # [b] int64
                       slot_offsets: torch.Tensor,  # [b] int64
                       tok: torch.Tensor) -> None:  # [b, kv, hd] fp
    """Write one fp K/V row per sequence into its int8 slot page, in place.

    Dequant the page, set the row, requant with a **monotone** scale
    ``new = max(old, amax|tok|/127)``; a write at offset 0 starts a fresh
    page, so the stale occupant's scale is discarded.  ``torch.round``
    rounds half to even, as ``jnp.round`` does.
    """
    b = tok.shape[0]
    sc = torch.where(slot_offsets[:, None] == 0,
                     torch.zeros((), device=scales.device),
                     scales[slot_pages])                        # [b, kv]
    fp = pages[slot_pages].float() * sc[:, None, :, None]
    tf = tok.float()
    fp[torch.arange(b, device=fp.device), slot_offsets] = tf
    need = tf.abs().amax(dim=-1) / 127.0
    nsc = torch.maximum(sc, need).clamp_min(1e-8)
    q8 = torch.round(fp / nsc[:, None, :, None]).clamp(-127, 127)
    pages[slot_pages] = q8.to(torch.int8)
    scales[slot_pages] = nsc


def _pad_pow2(src: List[int], dst: List[int],
              device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad the CoW op list to a power-of-two length.

    Padding repeats the last real (src, dst) pair, so duplicate scatter
    indices carry identical payloads.  An empty list stays empty.
    """
    n = len(src)
    if n:
        m = 1 << (n - 1).bit_length()
        src = src + [src[-1]] * (m - n)
        dst = dst + [dst[-1]] * (m - n)
    return (torch.tensor(src, dtype=torch.int64, device=device),
            torch.tensor(dst, dtype=torch.int64, device=device))


def _host(t: torch.Tensor) -> np.ndarray:
    """A pool slice as numpy; bf16 crosses as its 16-bit pattern."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# token tails as a lifecycle domain
# ---------------------------------------------------------------------------

class TokenDomain:
    """Host token tails plugged into the branch-lifecycle kernel.

    Each live sequence owns its generated-token list; the kernel's hooks
    move ownership on fork (copy), commit (child's tail replaces the
    parent's) and abort/invalidate (tail dropped).
    """

    def __init__(self) -> None:
        self._tokens: Dict[int, List[int]] = {}

    # -- BranchDomain hooks (called under the tree lock) ----------------
    def on_fork(self, parent: int, children: List[int]) -> None:
        base = self._tokens.get(parent)
        if base is not None:
            for c in children:
                self._tokens[c] = list(base)

    def on_commit(self, child: int, parent: int) -> None:
        if child in self._tokens:
            self._tokens[parent] = self._tokens.pop(child)

    def on_abort(self, branch: int) -> None:
        self._tokens.pop(branch, None)

    def on_invalidate(self, branch: int) -> None:
        self._tokens.pop(branch, None)

    def on_reap(self, branch: int) -> None:
        self._tokens.pop(branch, None)

    # -- accessors -------------------------------------------------------
    def seed(self, seq: int, tokens: Sequence[int]) -> None:
        self._tokens[seq] = list(tokens)

    def get(self, seq: int) -> List[int]:
        return self._tokens[seq]

    def append(self, seq: int, token: int) -> None:
        self._tokens[seq].append(token)

    def truncate(self, seq: int, n_tokens: int) -> None:
        del self._tokens[seq][n_tokens:]

    def __contains__(self, seq: int) -> bool:
        return seq in self._tokens

    def __len__(self) -> int:
        return len(self._tokens)


# ---------------------------------------------------------------------------
# the sharded parameters and pools
# ---------------------------------------------------------------------------

def scale_spec(plan: ParallelPlan) -> Tuple[Any, ...]:
    """Spec of the int8 dequant scales ``[L, n_pages, kv]``: the kv-head
    dim shards exactly as the pools', so each shard's scales stay with its
    pool slice."""
    return (None, None, plan.tp_axis)


class _Shard:
    """One tensor-parallel shard: its device, its slice of the parameter
    tree (with per-layer views) and its kv-head slice of the pools.  A pool
    has one page row past the branch manager's ``num_pages``: the scratch
    page, which no sequence holds and a padded decode row writes."""

    def __init__(self, cfg: ArchConfig, device: torch.device, params: Any,
                 kv_heads: int, num_pages: int, page_size: int,
                 quantized: bool):
        self.device = device
        self.params = params
        self.layers = [L.layer_params(params["layers"], i)
                       for i in range(cfg.num_layers)]
        dt = torch.int8 if quantized else torch_dtype(cfg)
        shape = (cfg.num_layers, num_pages + 1, page_size, kv_heads,
                 cfg.head_dim)
        self.k_pages = torch.zeros(shape, dtype=dt, device=device)
        self.v_pages = torch.zeros(shape, dtype=dt, device=device)
        self.k_scales: Optional[torch.Tensor] = None
        self.v_scales: Optional[torch.Tensor] = None
        if quantized:
            sshape = (cfg.num_layers, num_pages + 1, kv_heads)
            self.k_scales = torch.zeros(sshape, dtype=torch.float32,
                                        device=device)
            self.v_scales = torch.zeros(sshape, dtype=torch.float32,
                                        device=device)

    def pools(self) -> Pools:
        return [self.k_pages, self.v_pages, self.k_scales, self.v_scales]


class _DecodeRung:
    """The fused decode step's inputs at ``rows`` rows in static device
    buffers, and the step's CUDA graph over them once captured.

    One int32 buffer holds the block table ``[rows, max_pages]`` and six
    vectors of ``rows``: lengths, slot pages, slot offsets, tokens, CoW
    sources and CoW destinations (an append of one token faults at most one
    page a row).  A padded row has length 0, a zero block table, token 0
    and its slot on the scratch page; padded CoW pairs repeat the last real
    pair, or are (scratch, scratch) in a step without a fault, so every
    padded write lands on the scratch page or repeats a real one."""

    def __init__(self, rows: int, max_pages: int, device: torch.device):
        self.rows = rows
        self.buf = torch.zeros(rows * (max_pages + 6), dtype=torch.int32,
                               device=device)
        self.table = self.buf[:rows * max_pages].view(rows, max_pages)
        (self.lengths, self.pages, self.offsets, self.tokens, self.cow_src,
         self.cow_dst) = self.buf[rows * max_pages:].view(6, rows)
        self.graph: Optional[Any] = None     # torch.cuda.CUDAGraph
        self.logits: Optional[torch.Tensor] = None
        # (counter, kernel, launches) of one replay
        self.launches: List[Tuple[Dict[str, int], str, int]] = []

    def fill(self, host: np.ndarray, bt: np.ndarray, lengths: np.ndarray,
             slot_pages: List[int], slot_offsets: List[int],
             tokens: List[int], cow_src: List[int], cow_dst: List[int],
             scratch: int) -> None:
        """Lay a step of ``len(tokens)`` rows out in ``host``, the image of
        :attr:`buf`, padded to :attr:`rows`."""
        r, b = self.rows, len(tokens)
        table = host[:self.table.numel()].reshape(self.table.shape)
        table[:b] = bt
        table[b:] = 0
        vec = host[self.table.numel():].reshape(6, r)
        vec[:4, b:] = 0
        vec[1, b:] = scratch
        vec[:4, :b] = (lengths, slot_pages, slot_offsets, tokens)
        n = len(cow_src)
        assert n <= r, "more CoW faults than rows"
        vec[4:, :n] = (cow_src, cow_dst)
        vec[4:, n:] = np.array([[cow_src[-1]], [cow_dst[-1]]]) if n \
            else scratch


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

class ServeEngine:
    def __init__(self, model: Model, params: Any, *, num_pages: int = 256,
                 page_size: int = 16, max_pages_per_seq: int = 32,
                 attn_impl: str = "auto", kv_dtype: Optional[str] = None,
                 mesh: Optional[DeviceMesh] = None, tp: Optional[int] = None,
                 prefix_cache: bool = False,
                 tier_host_bytes: int = 64 << 20,
                 tier_disk_dir: Optional[str] = None,
                 obs: Optional[Observability] = None,
                 device: Any = None, seed: int = 0):
        if attn_impl not in ("auto", "ref"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', "
                             f"got {kv_dtype!r}")
        if kv_dtype == "int8" and attn_impl == "ref":
            raise ValueError(
                "kv_dtype='int8' requires the fused decode path "
                "(attn_impl 'auto'); the legacy 'ref' gather is fp-only")
        cfg = model.cfg
        check_engine_servable(cfg)
        self.model = model
        self.cfg: ArchConfig = cfg
        # --- serving mesh (tensor-parallel shards) ----------------------
        # tp=/mesh= shard the passes; unset keeps one shard holding the
        # whole model.  Branch bookkeeping (block tables, refcounts,
        # lifecycle tree, token tails) is host-side and exists once.
        if mesh is not None and device is not None:
            raise ValueError("name the shards' devices in mesh= or give "
                             "device=, not both")
        if mesh is None and tp is not None:
            mesh = tp_mesh(tp, device)
        self.mesh = mesh
        self.plan = serving_plan(mesh)
        self.tp = self.plan.tp_size
        if tp is not None and tp != self.tp:
            raise ValueError(
                f"tp={tp} contradicts the given mesh's tensor-parallel "
                f"width {self.tp}; pass one or the other")
        # a list: one tree per shard, already on its device (taken as it
        # is, as the JAX engine's device_put takes placed arrays)
        placed = isinstance(params, (list, tuple))
        if placed and not self.plan.is_distributed:
            raise ValueError("a list of shard trees needs tp= or mesh=")
        if self.plan.is_distributed:
            self._check_tp_divisibility(cfg, self.tp)
            like = model.init(device="meta") if placed else params
            specs = serve_specs(cfg, self.plan, like)
            devices = self.plan.devices
            if placed:
                check_shards(self.plan, specs, like, params)
                trees = list(params)
            else:
                trees = shard_params(cfg, self.plan, params, specs)
            # a vocab-sharded head's logits are gathered on shard 0
            self._gather_logits = self.plan.tp_axis in specs.get(
                "lm_head", ())
        else:
            devices = (resolve_device(device),)
            trees = [params_to(params, devices[0])]
            self._gather_logits = False
        self.devices: Tuple[torch.device, ...] = tuple(devices)
        # shard 0's device holds the residual stream, the logits and the
        # sampling state
        self.device = self.devices[0]
        # "auto" is the fused one-launch step; "ref" the legacy step
        self.fast_path = attn_impl == "auto"
        self.attn_impl = "fused" if self.fast_path else "ref"
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype == "int8"
        # the shards the kv heads split over (1: every shard holds them all)
        self.kv_tp = self.tp if kv_split(cfg, self.tp) else 1
        self.shards = [
            _Shard(cfg, dev, tree, cfg.num_kv_heads // self.kv_tp, num_pages,
                   page_size, self.quantized)
            for dev, tree in zip(self.devices, trees)]
        # sampling noise for decode(greedy=False) without a generator
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.obs = Observability() if obs is None else obs
        self.kv = KVBranchManager(num_pages=num_pages, page_size=page_size,
                                  obs=self.obs)
        self.page_size = page_size
        self.max_pages = max_pages_per_seq
        self.prefix_cache = prefix_cache
        self.tier = KVTierStore(host_bytes=tier_host_bytes,
                                disk_dir=tier_disk_dir, obs=self.obs)
        self.kv.tree.attach(self.tier)
        self.token_domain = TokenDomain()
        self.kv.tree.attach(self.token_domain)
        m = self.obs.metrics
        self._c_cow_dispatches = m.counter("engine.cow_dispatches")
        self._c_cow_faults = m.counter("engine.cow_faults")
        self._c_cow_inline_steps = m.counter("engine.cow_inline_steps")
        self._c_verify_dispatches = m.counter("engine.verify_dispatches")
        self._c_decode_steps = m.counter("engine.decode_steps")
        self._c_tokens = m.counter("engine.tokens_decoded")
        self._c_prefill_dispatches = m.counter("engine.prefill_dispatches")
        self._h_fork_us = m.histogram("engine.fork_us")
        self._h_commit_us = m.histogram("engine.commit_us")
        self._h_checkpoint_us = m.histogram("tier.checkpoint_us")
        self._h_restore_us = m.histogram("tier.restore_us")
        self._h_decode_us = m.histogram("engine.decode_step_us")
        self._h_batch = m.histogram("engine.batch_occupancy",
                                    lo=1.0, growth=2.0, buckets=12)
        self._c_graph_replays = m.counter("engine.decode_graph_replays")
        self._c_graph_captures = m.counter("engine.decode_graph_captures")
        self._c_padded_rows = m.counter("engine.decode_padded_rows")
        self._h_capture_ms = m.histogram("engine.decode_graph_capture_ms")
        # page_map without a redirect, over the pools' rows (the scratch
        # page, row num_pages, included)
        self._page_identity = torch.arange(num_pages + 1, dtype=torch.int32,
                                           device=self.device)
        # the fused step on one shard runs its rungs' static buffers (and
        # graphs, on a card) where padded rows cannot change a real row's
        # result: a dense FFN, or an MoE whose capacity drops no row
        self._rungs: Optional[Dict[int, _DecodeRung]] = (
            {} if self.fast_path and self.tp == 1 and (
                not cfg.is_moe or cfg.moe_capacity_factor
                * cfg.experts_per_token >= cfg.num_experts) else None)
        self._staging: Optional[torch.Tensor] = None
        self._graph_pool: Any = None
        # the pages the branch manager hands out (the scratch page is not
        # one of them)
        pool_bytes = sum(t[:, :num_pages].nbytes for sh in self.shards
                         for t in sh.pools() if t is not None)
        m.gauge(f"engine.kv_pool_bytes_{self.kv_dtype or 'fp'}").set(
            pool_bytes)
        m.gauge("engine.kv_pool_bytes").set(pool_bytes)

    @property
    def cow_dispatches(self) -> int:
        """Separate page-copy dispatches (eager fork CoW)."""
        return self._c_cow_dispatches.value

    @property
    def cow_faults(self) -> int:
        """Individual page copies serviced."""
        return self._c_cow_faults.value

    @property
    def cow_inline_steps(self) -> int:
        """Steps whose faults rode the fused decode step."""
        return self._c_cow_inline_steps.value

    @property
    def verify_dispatches(self) -> int:
        """Fused spec-verify passes."""
        return self._c_verify_dispatches.value

    @property
    def prefill_dispatches(self) -> int:
        """Prefill passes (dense or suffix) — a full prefix-cache hit
        performs zero."""
        return self._c_prefill_dispatches.value

    @staticmethod
    def _check_tp_divisibility(cfg: ArchConfig, tp: int) -> None:
        """Refuse a mesh the sums over shards could not be correct on.

        ``sanitize`` replicates a non-dividing dim: fine for an output dim
        (vocab), wrong for a dim the pass sums over, where every shard
        would compute the whole reduction and the sum would multiply it by
        ``tp``.  Those dims must divide; the attention heads need not
        (:func:`kv_split`: the block then runs whole on every shard and is
        added once).
        """
        if cfg.is_moe:
            if cfg.num_experts % tp:
                raise ValueError(
                    f"tp={tp} must divide num_experts={cfg.num_experts}")
        elif cfg.d_ff % tp:
            raise ValueError(
                f"tp={tp} must divide d_ff={cfg.d_ff} (the MLP "
                "down-projection sums over the sharded d_ff dim)")

    def _ints(self, x: Any) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.int32,
                               device=self.device)

    def _rep(self, x: torch.Tensor) -> List[torch.Tensor]:
        """A host-side input of a pass on every shard's device."""
        return broadcast(x, self.devices)

    # ------------------------------------------------------------------
    # the device passes: one body per pass, a Python loop over layers and,
    # inside it, over shards.  The residual stream lives on shard 0; each
    # sublayer's normed input is copied to every shard, each shard computes
    # its heads' (its d_ff's, its experts') partial, and the partials are
    # summed on shard 0 in shard order (collectives.psum).
    # ------------------------------------------------------------------
    def _layer_attention(self, i: int, h: torch.Tensor,
                         positions: List[torch.Tensor],
                         bt: List[torch.Tensor], lengths: List[torch.Tensor],
                         page_map: List[torch.Tensor]
                         ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                    List[torch.Tensor]]:
        """Pre-norm attention of layer ``i`` over the paged pool plus the
        inline chunk.  Returns (h + attention, each shard's chunk k and
        v)."""
        cfg = self.cfg
        b, t = h.shape[:2]
        x = L.rms_norm(h, self.shards[0].layers[i]["ln1"], cfg.norm_eps)
        parts, ks, vs = [], [], []
        for r, (sh, xr) in enumerate(zip(self.shards, self._rep(x))):
            lp = sh.layers[i]["attn"]
            q, k, v = L.qkv_project(cfg, lp, xr, positions[r])
            kvh = k.shape[2]
            qc = q.reshape(b, t, kvh, q.shape[2] // kvh, cfg.head_dim)
            ks_i = sh.k_scales[i] if self.quantized else None
            vs_i = sh.v_scales[i] if self.quantized else None
            a = paged_chunk_attention(qc, k, v, sh.k_pages[i], sh.v_pages[i],
                                      bt[r], lengths[r], page_map[r], ks_i,
                                      vs_i)
            parts.append(sharded.head_partial(
                a.reshape(b, t, -1, cfg.head_dim), lp["wo"],
                len(self.shards)))
            ks.append(k)
            vs.append(v)
        return h + self._attn_sum(i, parts), ks, vs

    def _attn_sum(self, i: int, parts: List[torch.Tensor]) -> torch.Tensor:
        """Layer ``i``'s attention output from the shards' partials
        (:func:`sharded.combine_heads`)."""
        return sharded.combine_heads(
            self.cfg, [sh.layers[i]["attn"] for sh in self.shards], parts)

    def _ffn(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """Layer ``i``'s post-attention FFN on the ln2-normed hidden, added
        to it: each shard's d_ff slice of the MLP, or its experts of the
        MoE block (every row of the pass routed together: the batch is
        never padded, capacity counts its rows), summed over shards."""
        x = L.rms_norm(h, self.shards[0].layers[i]["ln2"], self.cfg.norm_eps)
        y, _ = sharded.ffn(self.cfg, [sh.layers[i] for sh in self.shards],
                           self._rep(x))
        return h + y

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """Final norm and head on shard 0's device: a vocab-sharded head
        computes each shard's columns and gathers them."""
        cfg = self.cfg
        h = L.rms_norm(h, self.shards[0].params["final_norm"], cfg.norm_eps)
        if not self._gather_logits:
            return lm_head(cfg, self.shards[0].params, h)
        return sharded.gathered_logits(
            cfg, [sh.params for sh in self.shards], h)

    def _fused_decode_step(self, bt: np.ndarray, lengths: np.ndarray,
                           slot_pages: List[int], slot_offsets: List[int],
                           tokens: List[int], cow_src: List[int],
                           cow_dst: List[int]) -> torch.Tensor:
        """One fused decode step of ``b = len(tokens)`` rows from the
        host's inputs; returns logits ``[b, V]``.

        A batch on the rung ladder is laid out in a pinned host buffer,
        copied into its rung's static buffers at once and run there: the
        rung's first step eagerly, after which (on a card) the step is
        captured as a CUDA graph that every later step of the rung replays.
        Any other batch is uploaded tensor by tensor and runs eagerly."""
        tr = self.obs.tracer
        b = len(tokens)
        rung = self._decode_rung(b)
        if rung is None:
            args = (self._step_tensors(bt, lengths, slot_pages, slot_offsets,
                                       tokens)
                    + _pad_pow2(cow_src, cow_dst, self.device))
            if tr.enabled:
                tr.phase(ENGINE_TRACK, "engine.decode.forward",
                         layers=self.cfg.num_layers, graph=0, rung=0)
            return self._fused_forward(*args)
        on_card = self.device.type == "cuda"
        if self._staging is None:
            top = DECODE_RUNGS[-1] * (self.max_pages + 6)
            self._staging = torch.empty(top, dtype=torch.int32,
                                        pin_memory=on_card)
        # the last step's copy has read the staging buffer: every decode
        # ends in the host's readback of its tokens, after that copy
        host = self._staging[:rung.buf.numel()]
        rung.fill(host.numpy(), bt, lengths, slot_pages, slot_offsets, tokens,
                  cow_src, cow_dst, scratch=self.kv.num_pages)
        rung.buf.copy_(host, non_blocking=True)
        replay = rung.graph is not None
        if tr.enabled:
            tr.phase(ENGINE_TRACK, "engine.decode.forward",
                     layers=self.cfg.num_layers, graph=int(replay),
                     rung=rung.rows)
        if replay:
            rung.graph.replay()
            for counts, name, n in rung.launches:
                counts[name] += n
            self._c_graph_replays.inc()
            logits = rung.logits
        else:
            logits = self._rung_forward(rung)
            if on_card:
                self._capture(rung)
        self._c_padded_rows.inc(rung.rows - b)
        return logits[:b]

    def _step_tensors(self, bt: np.ndarray, lengths: np.ndarray,
                      slot_pages: List[int], slot_offsets: List[int],
                      tokens: List[int]) -> Tuple[torch.Tensor, ...]:
        """An eager decode step's inputs on the device, a copy each."""
        def longs(x: List[int]) -> torch.Tensor:
            return torch.tensor(x, dtype=torch.int64, device=self.device)
        return (self._ints(bt), self._ints(lengths), longs(slot_pages),
                longs(slot_offsets), longs(tokens)[:, None])

    def _decode_rung(self, b: int) -> Optional[_DecodeRung]:
        """The rung a decode of ``b`` rows runs at, or None where it runs
        the eager step: off the ladder, or an engine whose padded rows
        could change a real row (several shards, the legacy path, an MoE
        that drops rows)."""
        if self._rungs is None or b > DECODE_RUNGS[-1]:
            return None
        rows = next(r for r in DECODE_RUNGS if r >= b)
        if rows not in self._rungs:
            self._rungs[rows] = _DecodeRung(rows, self.max_pages,
                                            self.device)
        return self._rungs[rows]

    def _rung_forward(self, rung: _DecodeRung) -> torch.Tensor:
        """The fused step over a rung's static buffers: the body its graph
        captures."""
        return self._fused_forward(
            rung.table, rung.lengths, rung.pages.long(), rung.offsets.long(),
            rung.tokens.long()[:, None], rung.cow_src.long(),
            rung.cow_dst.long())

    def _capture(self, rung: _DecodeRung) -> None:
        """Capture the rung's step as a CUDA graph (its inputs already ran
        eagerly once, so every kernel's attributes and library handles are
        set up).  The rungs share one graph memory pool: their replays
        never overlap.  ``thread_local``: another thread may use the card
        meanwhile.  The kernel launches the capture's calls counted move to
        the rung, for its replays to count."""
        t0 = time.perf_counter_ns()
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = [dict(counts) for counts in _LAUNCH_COUNTERS]
        with torch.cuda.device(self.device), torch.cuda.graph(
                graph, pool=self._graph_pool,
                stream=torch.cuda.Stream(self.device),
                capture_error_mode="thread_local"):
            logits = self._rung_forward(rung)
        rung.launches = [(counts, name, counts[name] - was[name])
                         for counts, was in zip(_LAUNCH_COUNTERS, before)
                         for name in counts if counts[name] != was[name]]
        for counts, name, n in rung.launches:
            counts[name] -= n
        rung.graph, rung.logits = graph, logits
        self._c_graph_captures.inc()
        self._h_capture_ms.observe((time.perf_counter_ns() - t0) / 1e6)

    def _fused_forward(self, bt: torch.Tensor, lengths: torch.Tensor,
                       slot_pages: torch.Tensor, slot_offsets: torch.Tensor,
                       tokens: torch.Tensor, cow_src: torch.Tensor,
                       cow_dst: torch.Tensor) -> torch.Tensor:
        """The eager fused decode step over device inputs, CoW fault
        service included; returns logits ``[b, V]``.  Per layer, attention
        reads the pre-copy pool through ``page_map``; the page copies
        (scales too) and the token's slot write follow, in place, each
        shard on its kv-head slice."""
        page_map = self._page_identity
        if cow_src.numel():
            page_map = page_map.clone()
            page_map[cow_dst] = cow_src.to(torch.int32)
        h = embed_tokens(self.cfg, self.shards[0].params, tokens)
        bt, lens, page_map, slot_pages, slot_offsets, cow_src, cow_dst = (
            self._rep(x) for x in (bt, lengths, page_map, slot_pages,
                                   slot_offsets, cow_src, cow_dst))
        positions = [ln[:, None] for ln in lens]
        for i in range(self.cfg.num_layers):
            h, ks, vs = self._layer_attention(i, h, positions, bt, lens,
                                              page_map)
            for r, sh in enumerate(self.shards):
                if cow_src[r].numel():
                    for pool in sh.pools():
                        if pool is not None:
                            # the gather materialises src before the write
                            pool[i][cow_dst[r]] = pool[i][cow_src[r]]
                sp, so = slot_pages[r], slot_offsets[r]
                if self.quantized:
                    _quant_token_write(sh.k_pages[i], sh.k_scales[i], sp, so,
                                       ks[r][:, 0])
                    _quant_token_write(sh.v_pages[i], sh.v_scales[i], sp, so,
                                       vs[r][:, 0])
                else:
                    sh.k_pages[i][sp, so] = ks[r][:, 0]
                    sh.v_pages[i][sp, so] = vs[r][:, 0]
            h = self._ffn(i, h)
        return self._logits(h)[:, 0]

    def _legacy_decode_step(self, bt: torch.Tensor, lengths: torch.Tensor,
                            slot_pages: torch.Tensor,
                            slot_offsets: torch.Tensor, tokens: torch.Tensor
                            ) -> torch.Tensor:
        """The legacy decode step (``attn_impl="ref"``), CoW faults already
        serviced; returns logits ``[b, V]``.  Per layer each shard writes
        the token's K/V into its slot first, then cached-only attention
        reads the ``lengths + 1`` positions that now include it."""
        cfg = self.cfg
        b = tokens.shape[0]
        h = embed_tokens(cfg, self.shards[0].params, tokens)
        bt, lens, slot_pages, slot_offsets = (
            self._rep(x) for x in (bt, lengths, slot_pages, slot_offsets))
        for i in range(cfg.num_layers):
            x = L.rms_norm(h, self.shards[0].layers[i]["ln1"], cfg.norm_eps)
            parts = []
            for r, (sh, xr) in enumerate(zip(self.shards, self._rep(x))):
                lp = sh.layers[i]["attn"]
                q, k, v = L.qkv_project(cfg, lp, xr, lens[r][:, None])
                sh.k_pages[i][slot_pages[r], slot_offsets[r]] = k[:, 0]
                sh.v_pages[i][slot_pages[r], slot_offsets[r]] = v[:, 0]
                kvh = k.shape[2]
                qh = q.reshape(b, kvh, q.shape[2] // kvh, cfg.head_dim)
                a = paged_attention(qh, sh.k_pages[i], sh.v_pages[i], bt[r],
                                    lens[r] + 1)
                parts.append(sharded.head_partial(
                    a.reshape(b, 1, -1, cfg.head_dim), lp["wo"],
                    len(self.shards)))
            h = self._ffn(i, h + self._attn_sum(i, parts))
        return self._logits(h)[:, 0]

    def _chunk_pass(self, bt: torch.Tensor, lengths: torch.Tensor,
                    tokens: torch.Tensor, *, want_kv: bool):
        """Score ``t`` tokens per row over the cached prefix plus the
        causal in-chunk window, pools read-only.  Returns logits
        ``[b, t, V]``, or with ``want_kv`` each shard's per-layer chunk
        K/V (``[L, b, t, kv_local, hd]`` each, left on its shard) and no
        logits."""
        cfg = self.cfg
        t = tokens.shape[1]
        h = embed_tokens(cfg, self.shards[0].params, tokens)
        positions = lengths[:, None] + torch.arange(
            t, dtype=torch.int32, device=self.device)[None, :]
        positions, bt, lens, page_map = (
            self._rep(x) for x in (positions, bt, lengths,
                                   self._page_identity))
        ks = [[] for _ in self.shards]
        vs = [[] for _ in self.shards]
        for i in range(cfg.num_layers):
            h, k, v = self._layer_attention(i, h, positions, bt, lens,
                                            page_map)
            if want_kv:
                for r in range(self.tp):
                    ks[r].append(k[r])
                    vs[r].append(v[r])
                if i == cfg.num_layers - 1:
                    break       # the last layer's FFN feeds only logits
            h = self._ffn(i, h)
        if want_kv:
            return ([torch.stack(x) for x in ks],
                    [torch.stack(x) for x in vs])
        return self._logits(h)

    def _dense_pass(self, tokens: torch.Tensor
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """The dense prefill of a prompt ``[1, s]``: per layer each shard
        projects its heads, runs the flash attention kernel at its head
        count and its ``wo`` slice; the FFN as in every pass.  Returns each
        shard's per-layer K/V (``[L, 1, s, kv_local, hd]``), no logits."""
        cfg = self.cfg
        s = tokens.shape[1]
        h = embed_tokens(cfg, self.shards[0].params, tokens)
        positions = self._rep(torch.arange(s, device=self.device))
        ks = [[] for _ in self.shards]
        vs = [[] for _ in self.shards]
        for i in range(cfg.num_layers):
            x = L.rms_norm(h, self.shards[0].layers[i]["ln1"], cfg.norm_eps)
            a, k, v = sharded.attention(
                cfg, [sh.layers[i]["attn"] for sh in self.shards],
                self._rep(x), positions, attn=flash_attention)
            for r in range(self.tp):
                ks[r].append(k[r])
                vs[r].append(v[r])
            h = h + a
            if i < cfg.num_layers - 1:  # the last FFN feeds only logits
                h = self._ffn(i, h)
        return [torch.stack(x) for x in ks], [torch.stack(x) for x in vs]

    # ------------------------------------------------------------------
    def _scatter_prefill(self, pages: Sequence[int], ks: List[torch.Tensor],
                         vs: List[torch.Tensor], n_tokens: int) -> None:
        """Scatter ``n_tokens`` of per-layer K/V (each shard's ``[L, n,
        kv_local, hd]``) into ``pages`` of its pools, one indexed write per
        pool: token ``j`` lands in ``pages[j // page_size]`` at offset ``j %
        page_size``.  int8 pools quantize per page and kv head over the
        page's filled part."""
        ps = self.page_size
        n_pages = -(-n_tokens // ps)
        ids = torch.tensor(list(pages[:n_pages]), dtype=torch.int64,
                           device=self.device)
        for sh, k, v, page_ids in zip(self.shards, ks, vs, self._rep(ids)):
            j = torch.arange(n_tokens, device=sh.device)
            dst_page, dst_off = page_ids[j // ps], j % ps
            if not self.quantized:
                sh.k_pages[:, dst_page, dst_off] = k[:, :n_tokens]
                sh.v_pages[:, dst_page, dst_off] = v[:, :n_tokens]
                continue
            nl, _, kvh, hd = k.shape
            for pool, scales, src in ((sh.k_pages, sh.k_scales, k),
                                      (sh.v_pages, sh.v_scales, v)):
                fp = torch.zeros((nl, n_pages * ps, kvh, hd),
                                 dtype=torch.float32, device=sh.device)
                fp[:, :n_tokens] = src[:, :n_tokens].float()
                fp = fp.reshape(nl, n_pages, ps, kvh, hd)
                # zero padding never raises a page's amax
                sc = (fp.abs().amax(dim=(2, 4)) / 127.0).clamp_min(1e-8)
                q8 = torch.round(fp / sc[:, :, None, :, None]).clamp(-127,
                                                                     127)
                q8 = q8.to(torch.int8).reshape(nl, n_pages * ps, kvh, hd)
                pool[:, dst_page, dst_off] = q8[:, :n_tokens]
                scales[:, page_ids] = sc

    def _dense_prefill(self, sid: int, tokens: List[int]) -> None:
        """Full-prompt prefill: the dense pass, scattered into the table."""
        tr = self.obs.tracer
        if tr.enabled:
            tr.phase(ENGINE_TRACK, "engine.prefill.pass", kind="dense")
        toks = torch.tensor(tokens, dtype=torch.int64,
                            device=self.device)[None]
        ks, vs = self._dense_pass(toks)
        self._c_prefill_dispatches.inc()
        if tr.enabled:
            tr.phase(ENGINE_TRACK, "engine.prefill.scatter")
        self._scatter_prefill(self.kv.block_table(sid),
                              [k[:, 0] for k in ks], [v[:, 0] for v in vs],
                              len(tokens))
        if tr.enabled:
            tr.phase(ENGINE_TRACK, None)

    def _chunk_prefill(self, sid: int, tokens: List[int],
                       covered: int) -> None:
        """Suffix prefill: the first ``covered`` tokens are already in
        shared prefix pages; compute KV only for the remainder, attending
        to the shared pages through the block table (one pass).  Each
        shard's suffix K/V stays on its shard, sharded on the kv-head dim
        as its pools are: it is never regathered."""
        tr = self.obs.tracer
        if tr.enabled:
            tr.phase(ENGINE_TRACK, "engine.prefill.pass", kind="suffix")
        table = self.kv.block_table(sid)
        bt = np.zeros((1, self.max_pages), np.int32)
        bt[0, :len(table)] = table
        suffix = torch.tensor(tokens[covered:], dtype=torch.int64,
                              device=self.device)[None]
        ks, vs = self._chunk_pass(self._ints(bt), self._ints([covered]),
                                  suffix, want_kv=True)
        self._c_prefill_dispatches.inc()
        if tr.enabled:
            tr.phase(ENGINE_TRACK, "engine.prefill.scatter")
        # the prefix boundary is page-aligned (partial tail pages only
        # match whole prompts, which skip prefill entirely)
        self._scatter_prefill(table[covered // self.page_size:],
                              [k[:, 0] for k in ks], [v[:, 0] for v in vs],
                              len(tokens) - covered)
        if tr.enabled:
            tr.phase(ENGINE_TRACK, None)

    def add_request(self, prompt: Sequence[int]) -> int:
        """Prefill a prompt into a fresh paged sequence.

        Invariant: ``kv.length == len(tokens) - 1`` — the last token is
        pending: the decode step that consumes it writes its KV.  With
        ``prefix_cache`` the prompt's cached page runs are adopted CoW-
        shared and only the uncovered suffix is prefilled.
        """
        prompt = list(prompt)
        if not prompt:
            raise ValueError("empty prompt")
        tr = self.obs.tracer
        with (tr.span(ENGINE_TRACK, "engine.add_request") if tr.enabled
              else NO_SPAN) as span:
            if span is not None:
                tr.phase(ENGINE_TRACK, "engine.prefill.match")
            n_cached = len(prompt) - 1
            shared: List[int] = []
            covered = 0
            if self.prefix_cache and n_cached:
                shared, covered = self.kv.match_prefix(prompt[:-1])
            sid = self.kv.new_seq(length=n_cached,
                                  prefix_pages=shared or None)
            if span is not None:
                tr.phase(ENGINE_TRACK, None)
                span.args.update(seq=sid, cached=covered,
                                 new=n_cached - covered)
            if n_cached > covered:
                if covered:
                    self._chunk_prefill(sid, prompt[:-1], covered)
                else:
                    self._dense_prefill(sid, prompt[:-1])
            if self.prefix_cache and n_cached:
                if span is not None:
                    tr.phase(ENGINE_TRACK, "engine.prefill.register")
                self.kv.register_prefix(sid, prompt[:-1])
            self.token_domain.seed(sid, prompt)
            return sid

    # ------------------------------------------------------------------
    # branch ops (the paper's lifecycle, resolved by the shared kernel)
    # ------------------------------------------------------------------
    def fork(self, seq: int, n: int, *, eager_cow: bool = False) -> List[int]:
        """Fork ``n`` branches (token tails copied by the lifecycle hook).

        With ``eager_cow`` the shared-tail copy every child would fault at
        its first append is done at fork time, as one batched page copy
        for the whole sibling set.  The default stays lazy.
        """
        tr = self.obs.tracer
        with (tr.span(ENGINE_TRACK, "engine.fork", seq=seq, n=n)
              if tr.enabled else NO_SPAN):
            t0 = time.perf_counter_ns()
            if not eager_cow:
                children = self.kv.fork(seq, n)
            else:
                children, ops = self.kv.fork_batch(seq, n)
                if ops:
                    self._service_cow([op.src_page for op in ops],
                                      [op.dst_page for op in ops])
            self._h_fork_us.observe(
                (time.perf_counter_ns() - t0) / 1000.0 / n)
            return children

    def commit(self, seq: int) -> int:
        tr = self.obs.tracer
        with (tr.span(ENGINE_TRACK, "engine.commit", seq=seq) if tr.enabled
              else NO_SPAN):
            t0 = time.perf_counter_ns()
            parent = self.kv.commit(seq)  # tokens + pages promoted atomically
            self._h_commit_us.observe(
                (time.perf_counter_ns() - t0) / 1000.0)
            return parent

    def abort(self, seq: int) -> None:
        self.kv.abort(seq)

    def release(self, seq: int) -> None:
        """Evict a finished/abandoned sequence, freeing every domain."""
        self.kv.release(seq)

    def truncate(self, seq: int, n_tokens: int) -> None:
        """Keep only the first ``n_tokens`` tokens of a sequence."""
        if n_tokens < 1:
            raise ValueError("cannot truncate below one token")
        self.kv.truncate(seq, n_tokens - 1)
        self.token_domain.truncate(seq, n_tokens)

    # ------------------------------------------------------------------
    # tiering: checkpoint (demote) / restore (promote)
    # ------------------------------------------------------------------
    def checkpoint(self, seq: int) -> int:
        """Demote a branch's KV out of the device pool into the tier store.

        The snapshot keeps the pool's native dtype (bf16 as its 16-bit
        pattern, int8 with its scales) and the whole kv-head dim (the
        shards' slices concatenated in shard order), so :meth:`restore` is
        token-identical.  Returns the number of device pages freed.
        """
        t0 = time.perf_counter_ns()
        table = self.kv.block_table(seq)      # raises ENOENT if unknown
        length = self.kv.length(seq)
        tokens = list(self.token_domain.get(seq))
        idx = self._rep(torch.tensor(table, dtype=torch.int64,
                                     device=self.device))

        def gather(name: str, kv_dim: int) -> Optional[np.ndarray]:
            if getattr(self.shards[0], name) is None:
                return None
            return np.concatenate(
                [_host(getattr(sh, name)[:, i])
                 for sh, i in zip(self.shards[:self.kv_tp], idx)],
                axis=kv_dim)

        snap = KVSnapshot(
            seq_id=seq, length=length, n_pages=len(table), tokens=tokens,
            k_pages=gather("k_pages", 3), v_pages=gather("v_pages", 3),
            k_scales=gather("k_scales", 2), v_scales=gather("v_scales", 2))
        # demote AFTER the gather: it validates and raises with the
        # device state untouched
        self.kv.demote(seq)
        self.tier.put(snap)
        self._h_checkpoint_us.observe((time.perf_counter_ns() - t0) / 1000.0)
        return len(table)

    def restore(self, seq: int) -> None:
        """Re-seat a tiered branch into freshly allocated device pages,
        each shard taking its kv-head slice of the snapshot.

        Fails with the snapshot intact and the branch still tiered if the
        pool cannot fit it (``PoolExhausted``).
        """
        t0 = time.perf_counter_ns()
        snap = self.tier.get(seq)             # ENOENT if never tiered
        pages = self.kv.promote(seq)          # ENOSPC leaves snap stored
        if pages:
            kvl = self.cfg.num_kv_heads // self.kv_tp
            arrays = [(snap.k_pages, 3), (snap.v_pages, 3),
                      (snap.k_scales, 2), (snap.v_scales, 2)]
            for r, sh in enumerate(self.shards):
                idx = torch.tensor(pages, dtype=torch.int64,
                                   device=sh.device)
                for pool, (arr, kv_dim) in zip(sh.pools(), arrays):
                    if pool is None or arr is None:
                        continue
                    r0 = (r % self.kv_tp) * kvl
                    part = np.ascontiguousarray(np.take(
                        arr, range(r0, r0 + kvl), axis=kv_dim))
                    pool[:, idx] = torch.from_numpy(part).to(
                        sh.device).view(pool.dtype)
        self.token_domain.seed(seq, snap.tokens)
        self.tier.drop(seq)
        self._h_restore_us.observe((time.perf_counter_ns() - t0) / 1000.0)

    def is_tiered(self, seq: int) -> bool:
        return self.kv.is_tiered(seq)

    # ------------------------------------------------------------------
    def _service_cow(self, src: List[int], dst: List[int]) -> None:
        """Service CoW page copies (every layer, scales too) as one
        batched gather/scatter per pool; each shard copies its kv-head
        slice of every faulted page."""
        if not src:
            return
        s, d = _pad_pow2(src, dst, self.device)
        for sh, si, di in zip(self.shards, self._rep(s), self._rep(d)):
            for pool in sh.pools():
                if pool is not None:
                    pool[:, di] = pool[:, si]
        self._c_cow_dispatches.inc()
        self._c_cow_faults.inc(len(src))

    def decode(self, seq_ids: Sequence[int], *, greedy: Any = True,
               temperature: Any = 1.0,
               generator: Optional[torch.Generator] = None) -> List[int]:
        """One token for each sequence (they decode as one batch).

        ``greedy`` and ``temperature`` may be scalars or per-sequence
        lists.  Sampled rows draw Gumbel noise from ``generator`` (the
        engine's own, seeded at construction, when none is given).
        """
        b = len(seq_ids)
        tr = self.obs.tracer
        with (tr.span(ENGINE_TRACK, "engine.decode", rows=b) if tr.enabled
              else NO_SPAN) as span:
            if span is not None:
                tr.phase(ENGINE_TRACK, "engine.decode.prepare")
            t0 = time.perf_counter_ns()
            greedy_row = ([bool(greedy)] * b if isinstance(greedy, (bool, int))
                          else [bool(g) for g in greedy])
            temp_row = ([float(temperature)] * b
                        if isinstance(temperature, (int, float))
                        else [float(t) for t in temperature])
            if len(greedy_row) != b or len(temp_row) != b:
                raise ValueError("per-sequence sampling rows must match batch")
            lengths_before = np.array([self.kv.length(s) for s in seq_ids],
                                      np.int32)
            for s, ln in zip(seq_ids, lengths_before):
                if int(ln) // self.page_size + 1 > self.max_pages:
                    raise ValueError(
                        f"sequence {s} would need "
                        f"{int(ln) // self.page_size + 1} pages > "
                        f"{self.max_pages} (max_pages_per_seq)")
            # all-or-nothing slot reservation across the batch
            slot_lists = self.kv.prepare_append_batch(seq_ids, 1)
            slots = [sl[0] for sl in slot_lists]
            cow_src = [c.src_page for sl in slots for c in sl.cow]
            cow_dst = [c.dst_page for sl in slots for c in sl.cow]
            bt, _ = self.kv.dense_block_tables(seq_ids, self.max_pages)
            last = [self.token_domain.get(s)[-1] for s in seq_ids]
            if span is not None:
                span.args["cow"] = len(cow_src)
                tr.phase(ENGINE_TRACK, "engine.decode.upload")
            pages = [sl.page for sl in slots]
            offsets = [sl.offset for sl in slots]
            if self.fast_path:
                if cow_src:
                    self._c_cow_faults.inc(len(cow_src))
                    self._c_cow_inline_steps.inc()
                # the forward phase opens inside, after the upload
                logits = self._fused_decode_step(bt, lengths_before, pages,
                                                 offsets, last, cow_src,
                                                 cow_dst)
            else:
                step_args = self._step_tensors(bt, lengths_before, pages,
                                               offsets, last)
                if span is not None:
                    tr.phase(ENGINE_TRACK, "engine.decode.forward",
                             layers=self.cfg.num_layers, graph=0, rung=0)
                # legacy path: the faults are their own dispatch, first
                self._service_cow(cow_src, cow_dst)
                logits = self._legacy_decode_step(*step_args)
            if span is not None:
                tr.phase(ENGINE_TRACK, "engine.decode.sample")
            nxt = logits.argmax(dim=-1)
            if not all(greedy_row):
                gen = self.generator if generator is None else generator
                temps = torch.tensor(temp_row, dtype=torch.float32,
                                     device=self.device)
                u = torch.rand(logits.shape, generator=gen, device=self.device,
                               dtype=torch.float32)
                gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
                sampled = (logits.float() / temps[:, None] + gumbel).argmax(-1)
                keep = torch.tensor(greedy_row, device=self.device)
                nxt = torch.where(keep, nxt, sampled)
            if span is not None:
                tr.phase(ENGINE_TRACK, "engine.decode.readback")
            out = [int(t) for t in nxt.tolist()]
            if span is not None:
                tr.phase(ENGINE_TRACK, None)
            for s, t in zip(seq_ids, out):
                self.token_domain.append(s, t)
            # .tolist() above synced the device step
            dt_us = (time.perf_counter_ns() - t0) / 1000.0
            self._h_decode_us.observe(dt_us)
            self._h_batch.observe(b)
            self._c_decode_steps.inc()
            self._c_tokens.inc(b)
            if tr.enabled:
                tr.instant(ENGINE_TRACK, "decode_step", batch=b,
                           us=round(dt_us, 1))
            return out

    def spec_verify(self, seq: int,
                    drafts: Sequence[Sequence[int]]) -> List[List[int]]:
        """Score draft continuations of ``seq`` in ONE fused pass.

        Each row teacher-forces ``[pending_token] + draft[:-1]`` over the
        sequence's shared, read-only block table; returns the target's
        greedy token at every draft position, one row per draft.
        """
        drafts = [list(d) for d in drafts]
        if not drafts:
            raise ValueError("need at least one draft")
        t = len(drafts[0])
        if t < 1 or any(len(d) != t for d in drafts):
            raise ValueError("drafts must be non-empty and equal-length")
        length = self.kv.length(seq)       # raises if seq is not live
        pending = self.token_domain.get(seq)[-1]
        rows = torch.tensor([[pending] + d[:-1] for d in drafts],
                            dtype=torch.int64, device=self.device)
        bt_row, _ = self.kv.dense_block_tables([seq], self.max_pages)
        n = len(drafts)
        logits = self._chunk_pass(self._ints(np.tile(bt_row, (n, 1))),
                                  self._ints([length] * n), rows,
                                  want_kv=False)
        self._c_verify_dispatches.inc()
        return logits.argmax(dim=-1).tolist()

    def tokens(self, seq: int) -> List[int]:
        return list(self.token_domain.get(seq))

    def stats(self) -> Dict[str, Any]:
        st: Dict[str, Any] = dict(self.kv.stats())
        st["token_tails"] = len(self.token_domain)
        st["cow_dispatches"] = self.cow_dispatches
        st["cow_faults"] = self.cow_faults
        st["cow_inline_steps"] = self.cow_inline_steps
        st["verify_dispatches"] = self.verify_dispatches
        st["prefill_dispatches"] = self.prefill_dispatches
        st["prefix_cache"] = self.prefix_cache
        st["tier_snapshots"] = len(self.tier)
        st["tp"] = self.tp
        st["attn_impl"] = self.attn_impl
        st["kv_dtype"] = self.kv_dtype or self.cfg.dtype
        st["decode_graph_replays"] = self._c_graph_replays.value
        st["decode_graph_captures"] = self._c_graph_captures.value
        st["decode_padded_rows"] = self._c_padded_rows.value
        return st
