"""ServeEngine — branchable paged-KV serving on one CUDA device.

The PyTorch counterpart of ``repro/runtime/serve_loop.py``, single device:

* KV lives in fixed-size **pages** (``[L, n_pages, page, kv, hd]`` pools);
  sequences hold block tables managed by :class:`KVBranchManager`.
* ``fork(seq, n)`` creates N branches sharing every page (CoW); the first
  append to a shared tail page is a CoW fault.
* ``decode`` runs one fused step per token: every pending CoW fault of the
  batch arrives as a (src, dst) vector, attention reads the *pre-copy*
  pool through ``page_map`` (a faulted dst reads its src) with the fresh
  token's K/V inline, and only then are the page copies and the token's
  slot write applied, layer by layer.
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

Attention is :func:`repro_torch.kernels.paged_attention.
paged_chunk_attention` (fused decode, verify, suffix prefill — on both
paths), :func:`repro_torch.kernels.paged_attention.paged_attention` (the
legacy decode step) and, through the model's dense prefill,
:func:`repro_torch.kernels.flash_attention.flash_attention`: hand-written
CUDA kernels on the card, their plain versions for CPU tensors.

Unlike the JAX engine, which returns new pool arrays from every jitted
step, this engine **updates its pools in place** (indexed writes into
``k_pages``/``v_pages`` and the scales).  Not ported yet: ``tp=``/
``mesh=`` (ROADMAP, multi-GPU), which raise ``NotImplementedError``.
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
from repro_torch.kernels.paged_attention import (
    paged_attention,
    paged_chunk_attention,
)
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.models.moe import ffn
from repro_torch.models.transformer import (
    check_engine_servable,
    embed_tokens,
    lm_head,
    torch_dtype,
)
from repro_torch.obs import ENGINE_TRACK, Observability

Pools = List[Optional[torch.Tensor]]   # [k_pages, v_pages, k_scales, v_scales]


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
# engine
# ---------------------------------------------------------------------------

class ServeEngine:
    def __init__(self, model: Model, params: Any, *, num_pages: int = 256,
                 page_size: int = 16, max_pages_per_seq: int = 32,
                 attn_impl: str = "auto", kv_dtype: Optional[str] = None,
                 mesh: Any = None, tp: Optional[int] = None,
                 prefix_cache: bool = False,
                 tier_host_bytes: int = 64 << 20,
                 tier_disk_dir: Optional[str] = None,
                 obs: Optional[Observability] = None,
                 device: Any = None, seed: int = 0):
        if mesh is not None or tp is not None:
            raise NotImplementedError(
                "tensor-parallel serving (mesh=/tp=) is not ported yet: "
                "ROADMAP queue 1, item 13 (multi-GPU)")
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
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self._layers = [L.layer_params(self.params["layers"], i)
                        for i in range(cfg.num_layers)]
        self.tp = 1
        # "auto" is the fused one-launch step; "ref" the legacy step
        self.fast_path = attn_impl == "auto"
        self.attn_impl = "fused" if self.fast_path else "ref"
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype == "int8"
        # sampling noise for decode(greedy=False) without a generator
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.obs = Observability() if obs is None else obs
        self.kv = KVBranchManager(num_pages=num_pages, page_size=page_size,
                                  obs=self.obs)
        self.page_size = page_size
        self.max_pages = max_pages_per_seq
        dt = torch.int8 if self.quantized else torch_dtype(cfg)
        shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
                 cfg.head_dim)
        self.k_pages = torch.zeros(shape, dtype=dt, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dt, device=self.device)
        if self.quantized:
            sshape = (cfg.num_layers, num_pages, cfg.num_kv_heads)
            self.k_scales = torch.zeros(sshape, dtype=torch.float32,
                                        device=self.device)
            self.v_scales = torch.zeros(sshape, dtype=torch.float32,
                                        device=self.device)
        else:
            self.k_scales = None
            self.v_scales = None
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
        self._h_prefill_us = m.histogram("engine.prefill_us")
        self._h_checkpoint_us = m.histogram("tier.checkpoint_us")
        self._h_restore_us = m.histogram("tier.restore_us")
        self._h_decode_us = m.histogram("engine.decode_step_us")
        self._h_batch = m.histogram("engine.batch_occupancy",
                                    lo=1.0, growth=2.0, buckets=12)
        pool_bytes = sum(t.nbytes for t in self._pools() if t is not None)
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

    def _pools(self) -> Pools:
        return [self.k_pages, self.v_pages, self.k_scales, self.v_scales]

    def _ints(self, x: Any) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.int32,
                               device=self.device)

    # ------------------------------------------------------------------
    # the device passes: one body per pass, a Python loop over layers
    # ------------------------------------------------------------------
    def _layer_attention(self, i: int, lp: Any, h: torch.Tensor,
                         positions: torch.Tensor, bt: torch.Tensor,
                         lengths: torch.Tensor, page_map: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Pre-norm attention of layer ``i`` over the paged pool plus the
        inline chunk.  Returns (h + attention, chunk k, chunk v)."""
        cfg = self.cfg
        b, t = h.shape[:2]
        x = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
        q, k, v = L.qkv_project(cfg, lp["attn"], x, positions)
        kvh = k.shape[2]
        qc = q.reshape(b, t, kvh, q.shape[2] // kvh, cfg.head_dim)
        ks = self.k_scales[i] if self.quantized else None
        vs = self.v_scales[i] if self.quantized else None
        a = paged_chunk_attention(qc, k, v, self.k_pages[i], self.v_pages[i],
                                  bt, lengths, page_map, ks, vs)
        return h + L.attn_out(a.reshape(b, t, -1, cfg.head_dim),
                              lp["attn"]["wo"]), k, v

    def _ffn(self, lp: Any, h: torch.Tensor) -> torch.Tensor:
        """The layer's post-attention FFN on the ln2-normed hidden, added
        to it: the MLP, or the MoE block routing every row of the pass
        together (the batch is never padded: capacity counts its rows)."""
        x = L.rms_norm(h, lp["ln2"], self.cfg.norm_eps)
        return h + ffn(self.cfg, lp, x)

    def _identity_map(self) -> torch.Tensor:
        return torch.arange(self.kv.num_pages, dtype=torch.int32,
                            device=self.device)

    def _fused_decode_step(self, bt: torch.Tensor, lengths: torch.Tensor,
                           slot_pages: torch.Tensor,
                           slot_offsets: torch.Tensor, tokens: torch.Tensor,
                           cow_src: torch.Tensor, cow_dst: torch.Tensor
                           ) -> torch.Tensor:
        """One decode step, CoW fault service included; returns logits
        ``[b, V]``.  Per layer, attention reads the pre-copy pool through
        ``page_map``; the page copies (scales too) and the token's slot
        write follow, in place."""
        cfg = self.cfg
        h = embed_tokens(cfg, self.params, tokens)
        page_map = self._identity_map()
        if cow_src.numel():
            page_map[cow_dst] = cow_src.to(torch.int32)
        for i, lp in enumerate(self._layers):
            h, k, v = self._layer_attention(i, lp, h, lengths[:, None], bt,
                                            lengths, page_map)
            if cow_src.numel():
                for pool in self._pools():
                    if pool is not None:
                        # the gather materialises src before the write
                        pool[i][cow_dst] = pool[i][cow_src]
            if self.quantized:
                _quant_token_write(self.k_pages[i], self.k_scales[i],
                                   slot_pages, slot_offsets, k[:, 0])
                _quant_token_write(self.v_pages[i], self.v_scales[i],
                                   slot_pages, slot_offsets, v[:, 0])
            else:
                self.k_pages[i][slot_pages, slot_offsets] = k[:, 0]
                self.v_pages[i][slot_pages, slot_offsets] = v[:, 0]
            h = self._ffn(lp, h)
        h = L.rms_norm(h, self.params["final_norm"], cfg.norm_eps)
        return lm_head(cfg, self.params, h)[:, 0]

    def _legacy_decode_step(self, bt: torch.Tensor, lengths: torch.Tensor,
                            slot_pages: torch.Tensor,
                            slot_offsets: torch.Tensor, tokens: torch.Tensor
                            ) -> torch.Tensor:
        """The legacy decode step (``attn_impl="ref"``), CoW faults already
        serviced; returns logits ``[b, V]``.  Per layer the token's K/V is
        written into its slot first, then cached-only attention reads the
        ``lengths + 1`` positions that now include it."""
        cfg = self.cfg
        b = tokens.shape[0]
        h = embed_tokens(cfg, self.params, tokens)
        for i, lp in enumerate(self._layers):
            x = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
            q, k, v = L.qkv_project(cfg, lp["attn"], x, lengths[:, None])
            self.k_pages[i][slot_pages, slot_offsets] = k[:, 0]
            self.v_pages[i][slot_pages, slot_offsets] = v[:, 0]
            kvh = k.shape[2]
            qh = q.reshape(b, kvh, q.shape[2] // kvh, cfg.head_dim)
            a = paged_attention(qh, self.k_pages[i], self.v_pages[i], bt,
                                lengths + 1)
            h = h + L.attn_out(a.reshape(b, 1, -1, cfg.head_dim),
                               lp["attn"]["wo"])
            h = self._ffn(lp, h)
        h = L.rms_norm(h, self.params["final_norm"], cfg.norm_eps)
        return lm_head(cfg, self.params, h)[:, 0]

    def _chunk_pass(self, bt: torch.Tensor, lengths: torch.Tensor,
                    tokens: torch.Tensor, *, want_kv: bool):
        """Score ``t`` tokens per row over the cached prefix plus the
        causal in-chunk window, pools read-only.  Returns logits
        ``[b, t, V]``, or with ``want_kv`` the chunk's per-layer K/V
        (``[L, b, t, kv, hd]`` each) and no logits."""
        cfg = self.cfg
        t = tokens.shape[1]
        h = embed_tokens(cfg, self.params, tokens)
        positions = lengths[:, None] + torch.arange(
            t, dtype=torch.int32, device=self.device)[None, :]
        page_map = self._identity_map()
        ks, vs = [], []
        for i, lp in enumerate(self._layers):
            h, k, v = self._layer_attention(i, lp, h, positions, bt,
                                            lengths, page_map)
            if want_kv:
                ks.append(k)
                vs.append(v)
                if i == cfg.num_layers - 1:
                    break       # the last layer's MLP feeds only logits
            h = self._ffn(lp, h)
        if want_kv:
            return torch.stack(ks), torch.stack(vs)
        h = L.rms_norm(h, self.params["final_norm"], cfg.norm_eps)
        return lm_head(cfg, self.params, h)

    # ------------------------------------------------------------------
    def _scatter_prefill(self, pages: Sequence[int], k: torch.Tensor,
                         v: torch.Tensor, n_tokens: int) -> None:
        """Scatter ``n_tokens`` of per-layer K/V (``[L, n, kv, hd]``) into
        ``pages`` in one indexed write per pool: token ``j`` lands in
        ``pages[j // page_size]`` at offset ``j % page_size``.  int8 pools
        quantize per page and kv head over the page's filled part."""
        ps = self.page_size
        n_pages = -(-n_tokens // ps)
        page_ids = torch.tensor(list(pages[:n_pages]), dtype=torch.int64,
                                device=self.device)
        j = torch.arange(n_tokens, device=self.device)
        dst_page, dst_off = page_ids[j // ps], j % ps
        if not self.quantized:
            self.k_pages[:, dst_page, dst_off] = k[:, :n_tokens]
            self.v_pages[:, dst_page, dst_off] = v[:, :n_tokens]
            return
        nl, _, kvh, hd = k.shape
        for pool, scales, src in ((self.k_pages, self.k_scales, k),
                                  (self.v_pages, self.v_scales, v)):
            fp = torch.zeros((nl, n_pages * ps, kvh, hd), dtype=torch.float32,
                             device=self.device)
            fp[:, :n_tokens] = src[:, :n_tokens].float()
            fp = fp.reshape(nl, n_pages, ps, kvh, hd)
            # zero padding never raises a page's amax
            sc = (fp.abs().amax(dim=(2, 4)) / 127.0).clamp_min(1e-8)
            q8 = torch.round(fp / sc[:, :, None, :, None]).clamp(-127, 127)
            q8 = q8.to(torch.int8).reshape(nl, n_pages * ps, kvh, hd)
            pool[:, dst_page, dst_off] = q8[:, :n_tokens]
            scales[:, page_ids] = sc

    def _dense_prefill(self, sid: int, tokens: List[int]) -> None:
        """Full-prompt prefill: dense forward, scatter into the table."""
        toks = torch.tensor(tokens, dtype=torch.int64,
                            device=self.device)[None]
        _, cache = self.model.prefill(self.params, toks)
        self._c_prefill_dispatches.inc()
        self._scatter_prefill(self.kv.block_table(sid), cache["k"][:, 0],
                              cache["v"][:, 0], len(tokens))

    def _chunk_prefill(self, sid: int, tokens: List[int],
                       covered: int) -> None:
        """Suffix prefill: the first ``covered`` tokens are already in
        shared prefix pages; compute KV only for the remainder, attending
        to the shared pages through the block table (one pass)."""
        table = self.kv.block_table(sid)
        bt = np.zeros((1, self.max_pages), np.int32)
        bt[0, :len(table)] = table
        suffix = torch.tensor(tokens[covered:], dtype=torch.int64,
                              device=self.device)[None]
        k, v = self._chunk_pass(self._ints(bt), self._ints([covered]),
                                suffix, want_kv=True)
        self._c_prefill_dispatches.inc()
        # the prefix boundary is page-aligned (partial tail pages only
        # match whole prompts, which skip prefill entirely)
        self._scatter_prefill(table[covered // self.page_size:],
                              k[:, 0], v[:, 0], len(tokens) - covered)

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
        t0 = time.perf_counter_ns()
        n_cached = len(prompt) - 1
        shared: List[int] = []
        covered = 0
        if self.prefix_cache and n_cached:
            shared, covered = self.kv.match_prefix(prompt[:-1])
        sid = self.kv.new_seq(length=n_cached, prefix_pages=shared or None)
        if n_cached > covered:
            if covered:
                self._chunk_prefill(sid, prompt[:-1], covered)
            else:
                self._dense_prefill(sid, prompt[:-1])
        if self.prefix_cache and n_cached:
            self.kv.register_prefix(sid, prompt[:-1])
        self.token_domain.seed(sid, prompt)
        self._h_prefill_us.observe((time.perf_counter_ns() - t0) / 1000.0)
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
        t0 = time.perf_counter_ns()
        if not eager_cow:
            children = self.kv.fork(seq, n)
        else:
            children, ops = self.kv.fork_batch(seq, n)
            if ops:
                self._service_cow([op.src_page for op in ops],
                                  [op.dst_page for op in ops])
        self._h_fork_us.observe((time.perf_counter_ns() - t0) / 1000.0 / n)
        return children

    def commit(self, seq: int) -> int:
        t0 = time.perf_counter_ns()
        parent = self.kv.commit(seq)  # tokens + pages promoted atomically
        self._h_commit_us.observe((time.perf_counter_ns() - t0) / 1000.0)
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
        pattern, int8 with its scales), so :meth:`restore` is
        token-identical.  Returns the number of device pages freed.
        """
        t0 = time.perf_counter_ns()
        table = self.kv.block_table(seq)      # raises ENOENT if unknown
        length = self.kv.length(seq)
        tokens = list(self.token_domain.get(seq))
        idx = torch.tensor(table, dtype=torch.int64, device=self.device)
        snap = KVSnapshot(
            seq_id=seq, length=length, n_pages=len(table), tokens=tokens,
            k_pages=_host(self.k_pages[:, idx]),
            v_pages=_host(self.v_pages[:, idx]),
            k_scales=(_host(self.k_scales[:, idx])
                      if self.quantized else None),
            v_scales=(_host(self.v_scales[:, idx])
                      if self.quantized else None))
        # demote AFTER the gather: it validates and raises with the
        # device state untouched
        self.kv.demote(seq)
        self.tier.put(snap)
        self._h_checkpoint_us.observe((time.perf_counter_ns() - t0) / 1000.0)
        return len(table)

    def restore(self, seq: int) -> None:
        """Re-seat a tiered branch into freshly allocated device pages.

        Fails with the snapshot intact and the branch still tiered if the
        pool cannot fit it (``PoolExhausted``).
        """
        t0 = time.perf_counter_ns()
        snap = self.tier.get(seq)             # ENOENT if never tiered
        pages = self.kv.promote(seq)          # ENOSPC leaves snap stored
        if pages:
            idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
            arrays = [snap.k_pages, snap.v_pages, snap.k_scales,
                      snap.v_scales]
            for pool, arr in zip(self._pools(), arrays):
                if pool is not None and arr is not None:
                    pool[:, idx] = torch.from_numpy(arr).to(
                        self.device).view(pool.dtype)
        self.token_domain.seed(seq, snap.tokens)
        self.tier.drop(seq)
        self._h_restore_us.observe((time.perf_counter_ns() - t0) / 1000.0)

    def is_tiered(self, seq: int) -> bool:
        return self.kv.is_tiered(seq)

    # ------------------------------------------------------------------
    def _service_cow(self, src: List[int], dst: List[int]) -> None:
        """Service CoW page copies (every layer, scales too) as one
        batched gather/scatter per pool."""
        if not src:
            return
        s, d = _pad_pow2(src, dst, self.device)
        for pool in self._pools():
            if pool is not None:
                pool[:, d] = pool[:, s]
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
        if not self.fast_path:
            # legacy path: the faults are their own dispatch, first
            self._service_cow(cow_src, cow_dst)
        bt, _ = self.kv.dense_block_tables(seq_ids, self.max_pages)
        last = [self.token_domain.get(s)[-1] for s in seq_ids]
        step_args = (
            self._ints(bt), self._ints(lengths_before),
            torch.tensor([sl.page for sl in slots], dtype=torch.int64,
                         device=self.device),
            torch.tensor([sl.offset for sl in slots], dtype=torch.int64,
                         device=self.device),
            torch.tensor(last, dtype=torch.int64, device=self.device)[:, None])
        if self.fast_path:
            cs, cd = _pad_pow2(cow_src, cow_dst, self.device)
            if cow_src:
                self._c_cow_faults.inc(len(cow_src))
                self._c_cow_inline_steps.inc()
            logits = self._fused_decode_step(*step_args, cs, cd)
        else:
            logits = self._legacy_decode_step(*step_args)
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
        out = [int(t) for t in nxt.tolist()]
        for s, t in zip(seq_ids, out):
            self.token_domain.append(s, t)
        # .tolist() above synced the device step
        dt_us = (time.perf_counter_ns() - t0) / 1000.0
        self._h_decode_us.observe(dt_us)
        self._h_batch.observe(b)
        self._c_decode_steps.inc()
        self._c_tokens.inc(b)
        tr = self.obs.tracer
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
        return st
