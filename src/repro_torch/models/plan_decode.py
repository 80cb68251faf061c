"""Prefill and one-token decode over a (pod, data, model) plan: the
counterparts of ``prefill(..., plan=)`` and ``decode_step(..., plan=)`` in
``repro/models/decode.py``, for every family.

One host process drives every mesh position, as the training forward does
(``models/transformer.py``):

* Each data position takes its rows of the batch (``batch_spec``:
  contiguous, in position order) and runs them on its row of the mesh
  (``plan.grid[d]``).  Inside it every sublayer runs the shard-local passes
  of :mod:`repro_torch.models.sharded` over the model positions:
  attention over their heads (whole on each where the heads do not split:
  ``sharding.heads_split``), the FFN over d_ff or the MoE block over their
  experts (each data position routing its own rows, as ``moe_block(...,
  dp_axes=)``), the Mamba2 block over its SSD heads with the gated norm's
  squares summed across, and the hybrid's shared block.  Each layer's part
  of the parameters is gathered at use (``sharding.position_params``).
* The decode cache is stored as blocks (:class:`~repro_torch.distributed.
  blocked.Blocked`) laid out by ``state_shardings``: K/V ``[L, b, S, kv,
  hd]`` with the batch over ``data`` and the sequence over ``model``, the
  conv state's channels and the SSM state's heads over ``model``.  A
  prefill writes each position's rows into the blocks that hold them
  (:func:`blocked.put`); a decode step writes the token's K/V row into the
  block holding its position, in place, and steps the SSM state out of
  place into new blocks, as the single-device step does.
* Decode attention is sequence-parallel over the cache's blocks: each
  model position scores every head against the keys of its sequence block
  (f32), and the partial softmax states (max, sum, weighted values) are
  merged across the positions; the output then goes through each
  position's ``wo`` rows.  This is plain torch, as the contiguous-cache
  decode attention is on one device (the JAX package's is jnp, no Pallas
  kernel).  The prefill's attention is the flash attention kernel at each
  position's head counts; the SSD scan is the scan kernel.
* The logits are each data position's, gathered over the vocab as
  ``sharded.gathered_logits`` does, and concatenated over the data
  positions on the mesh's first device.

The data positions run through :func:`repro_torch.accounting.repeats`, so
inside the dry run's ``one_of_each`` only the first runs and counts for
all.  The copies that move a prefill's K/V from the positions that computed
it onto the blocks that store it are not reported as collectives.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import accounting
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.blocked import (
    filled,
    is_blocked,
    piece,
    put,
    take,
)
from repro_torch.distributed.collectives import all_gather, broadcast, psum
from repro_torch.distributed.mesh import ParallelPlan, Region, split_range
from repro_torch.distributed.sharding import (
    kv_range,
    mamba_ranges,
    position_params,
    state_shardings,
)
from repro_torch.models import layers as L
from repro_torch.models import sharded
from repro_torch.models.decode import decode_state_specs
from repro_torch.models.sharded import AXES
from repro_torch.models.ssm import (
    conv1d_decode,
    mamba_scan,
    softplus_dt,
    ssd_decode_step,
)
from repro_torch.models.transformer import (
    ATTN_FAMILIES,
    SSM_FAMILIES,
    embed_tokens,
    position_head,
    position_rows,
)

Params = Dict[str, Any]
Cache = Dict[str, Any]


def init_cache(cfg: ArchConfig, plan: ParallelPlan, batch: int,
               max_len: int, value: Optional[float] = 0.0) -> Cache:
    """A decode cache laid out by ``state_shardings`` over the plan's mesh,
    each block on its owner's device, filled with ``value`` (``None``:
    unwritten)."""
    specs = decode_state_specs(cfg, batch, max_len)
    shardings = state_shardings(
        cfg, plan, {k: torch.empty(s, device="meta")
                    for k, (s, _) in specs.items()})
    return {k: filled(shape, dt, shardings[k], value)
            for k, (shape, dt) in specs.items()}


def _over_positions(plan: ParallelPlan, fn: Callable[[int], Any]) -> List:
    """``fn(d)`` for every data position (one of each inside the dry run's
    ``one_of_each``: the others reuse the first's result)."""
    outs: List = []
    for d, weight in accounting.repeats(plan.dp_size):
        if weight:
            with accounting.scaled(weight):
                outs.append(fn(d))
        else:
            outs.append(outs[0])
    return outs


def _gather_logits(plan: ParallelPlan, logits: Sequence[torch.Tensor]
                   ) -> torch.Tensor:
    first = plan.grid[0][0]
    return torch.cat([x.to(first) for x in logits])


class _Position:
    """Data position ``d``'s row of the mesh and its rows of the batch."""

    def __init__(self, cfg: ArchConfig, plan: ParallelPlan, d: int,
                 b: int):
        self.cfg = cfg
        self.row = plan.grid[d]
        self.tp = len(self.row)
        self.home = self.row[0]
        self.rows = b // plan.dp_size
        self.r0 = d * self.rows

    def parts(self, tree: Params, path: Tuple[str, ...] = ()
              ) -> List[Params]:
        return [position_params(self.cfg, tree, r, self.tp, dev, path)
                for r, dev in enumerate(self.row)]

    def ffn(self, lps: Sequence[Params], x: torch.Tensor) -> torch.Tensor:
        return sharded.ffn(self.cfg, lps, broadcast(x, self.row))[0]

    def region(self, leaf: Any, i: int, *dims: Tuple[int, int]) -> Region:
        """Layer ``i``'s region of a cache leaf over this position's rows,
        ``dims`` on the dims after the batch (the rest whole)."""
        rest = [(0, n) for n in leaf.shape[2:]]
        rest[:len(dims)] = dims
        return ((i, 1), (self.r0, self.rows), *rest)


def _heads(cfg: ArchConfig, lps: Sequence[Params],
           parts: Sequence[torch.Tensor], kv: bool) -> torch.Tensor:
    """The whole head dim (dim 2) of q (``kv`` False) or of k/v on the
    first position, from the model positions' parts: the first's where
    every position holds every head; else the query heads' disjoint ranges
    gathered, or each kv head once, from the first position using it."""
    if len(parts) == 1 or sharded.replicated(cfg, lps):
        return parts[0]
    if not kv:
        return all_gather(parts, dim=2, axes=AXES)
    uniq, seen = [], 0
    for r, x in enumerate(parts):
        k0, n = kv_range(cfg, r, len(parts))
        if k0 + n > seen:
            uniq.append(x[:, :, seen - k0:])
            seen = k0 + n
    return all_gather(uniq, dim=2, axes=AXES)


def _attn_out(cfg: ArchConfig, pos: _Position, lps: Sequence[Params],
              out: torch.Tensor) -> torch.Tensor:
    """``out`` ``[b, t, h, hd]`` (every head, on the first position)
    through each model position's ``wo`` rows, combined."""
    rep = sharded.replicated(cfg, lps)
    parts = []
    for r, (lp, o) in enumerate(zip(lps, broadcast(out, pos.row))):
        if pos.tp > 1 and not rep:
            q0, nq = split_range(cfg.num_heads, pos.tp, r)
            o = o[:, :, q0:q0 + nq]
        parts.append(sharded.head_partial(o, lp["wo"], len(lps)))
    return sharded.combine_heads(cfg, lps, parts)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def prefill(cfg: ArchConfig, p: Params, plan: ParallelPlan,
            tokens: torch.Tensor,
            frontend_embed: Optional[torch.Tensor] = None, *,
            max_len: Optional[int] = None, attn_chunk: int = 1024
            ) -> Tuple[torch.Tensor, Cache]:
    """The prompt over the plan's mesh -> (last-position logits on the
    mesh's first device, the cache as blocks); the single-device
    ``decode.prefill``'s contract."""
    b, s = tokens.shape[:2]
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} < prompt length {s}")
    if cfg.family in SSM_FAMILIES and s < cfg.ssm_conv_kernel - 1:
        raise ValueError(f"an SSM prompt needs at least "
                         f"{cfg.ssm_conv_kernel - 1} tokens, got {s}")
    cache = init_cache(cfg, plan, b, max_len)
    rows = position_rows(plan, tokens, frontend_embed)
    chunk = min(attn_chunk, s)

    def one(d: int) -> torch.Tensor:
        pos = _Position(cfg, plan, d, b)
        tok, fe = rows[d]
        return _prefill_position(cfg, p, plan, d, pos, tok, fe, cache, s,
                                 chunk)

    return _gather_logits(plan, _over_positions(plan, one)), cache


def _prefill_position(cfg: ArchConfig, p: Params, plan: ParallelPlan,
                      d: int, pos: _Position, tokens: torch.Tensor,
                      fe: Optional[torch.Tensor], cache: Cache, s: int,
                      chunk: int) -> torch.Tensor:
    home, row = pos.home, pos.row
    h = embed_tokens(cfg, {k: take(p[k], home) for k in
                           ("embed", "frontend_proj") if k in p}, tokens, fe)
    positions = broadcast(torch.arange(s, device=home), row)
    layers = L.unstack_layers(p["layers"], cfg.num_layers)

    def attention(lps: Sequence[Params], x: torch.Tensor, i: int
                  ) -> torch.Tensor:
        """The attention sublayer; its K/V into the cache's layer ``i``."""
        alps = [lp["attn"] for lp in lps]
        a, ks, vs = sharded.attention(cfg, alps, broadcast(x, row),
                                      positions, chunk)
        for name, parts in (("k", ks), ("v", vs)):
            put(cache[name], pos.region(cache[name], i, (0, s)),
                _heads(cfg, alps, parts, kv=True)[None])
        return a

    if cfg.family in ATTN_FAMILIES:
        for i, lv in enumerate(layers):
            lps = pos.parts(lv)
            h = h + attention(lps, L.rms_norm(h, lps[0]["ln1"], cfg.norm_eps),
                              i)
            h = h + pos.ffn(lps, L.rms_norm(h, lps[0]["ln2"], cfg.norm_eps))
    else:
        h0, every = h, cfg.attn_every
        n_apps = cfg.num_layers // every if cfg.family == "hybrid" else 0
        for i, lv in enumerate(layers):
            lps = pos.parts(lv)
            x = L.rms_norm(h, lps[0]["ln"], cfg.norm_eps)
            h = h + _mamba_prefill(cfg, pos, [lp["mamba"] for lp in lps], x,
                                   cache, i)
            if n_apps and (i + 1) % every == 0 and i < n_apps * every:
                sps = pos.parts(_shared(p), ("shared",))
                x = torch.cat([h, h0], dim=-1) @ take(
                    p["shared"]["w_concat"], home)
                x = x + attention(sps, L.rms_norm(x, sps[0]["ln1"],
                                                  cfg.norm_eps), i // every)
                h = h + x + pos.ffn(sps, L.rms_norm(x, sps[0]["ln2"],
                                                    cfg.norm_eps))
    h = L.rms_norm(h[:, -1:], take(p["final_norm"], home), cfg.norm_eps)
    return position_head(cfg, p, plan, d)(h)


def _shared(p: Params) -> Params:
    return {k: v for k, v in p["shared"].items() if k != "w_concat"}


def _conv_channels(cfg: ArchConfig, r: int, tp: int
                   ) -> List[Tuple[int, int]]:
    """Model position ``r``'s channels of the conv state (its heads' x,
    then B and C): :func:`sharding.mamba_ranges` of ``conv_w``."""
    if tp == 1:
        return [(0, cfg.ssm_conv_dim)]
    return mamba_ranges(cfg, "conv_w", r, tp)


def _put_state(cfg: ArchConfig, pos: _Position, cache: Cache, i: int,
               convs: Sequence[torch.Tensor], ssms: Sequence[torch.Tensor]
               ) -> None:
    """Write each model position's conv state (its x channels, and B and C
    from the first) and SSM state (its heads) into layer ``i`` of the
    cache's ``conv``/``ssm`` over this position's rows."""
    P = cfg.ssm_head_dim
    for r, (conv, ssm) in enumerate(zip(convs, ssms)):
        h0, nh = split_range(cfg.ssm_heads, pos.tp, r)
        ranges = _conv_channels(cfg, r, pos.tp)
        if pos.tp > 1:
            put(cache["conv"], pos.region(cache["conv"], i, (0, conv.shape[1]),
                                          (h0 * P, nh * P)),
                conv[None, :, :, :nh * P])
            if r == 0:
                bc0, bcn = ranges[1]
                put(cache["conv"], pos.region(cache["conv"], i,
                                              (0, conv.shape[1]),
                                              (bc0, bcn)),
                    conv[None, :, :, nh * P:])
        else:
            put(cache["conv"], pos.region(cache["conv"], i), conv[None])
        put(cache["ssm"], pos.region(cache["ssm"], i, (h0, nh)), ssm[None])


def _mamba_prefill(cfg: ArchConfig, pos: _Position, lps: Sequence[Params],
                   x: torch.Tensor, cache: Cache, i: int) -> torch.Tensor:
    """One Mamba2 block over the prompt across the model positions (the
    scan kernel over each one's heads); its states into layer ``i``."""
    outs = [mamba_scan(cfg, lp, xr)
            for lp, xr in zip(lps, broadcast(x, pos.row))]
    ys = sharded.gated_rms_norm([o[0] for o in outs], [o[1] for o in outs],
                                [lp["norm_w"] for lp in lps], cfg.norm_eps,
                                cfg.ssm_d_inner)
    _put_state(cfg, pos, cache, i, [o[2] for o in outs],
               [o[3] for o in outs])
    return sharded.out_proj_sum(ys, lps)


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def decode_step(cfg: ArchConfig, p: Params, plan: ParallelPlan,
                cache: Cache, tokens: torch.Tensor, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Cache]:
    """One token for every sequence over the plan's mesh -> (logits on the
    mesh's first device, the cache): the single-device ``decode_step``'s
    contract (K/V rows written into the blocks it is given; the SSM state
    stepped into new blocks)."""
    b = tokens.shape[0]
    new = dict(cache)
    if cfg.family in SSM_FAMILIES:
        for name in ("conv", "ssm"):
            new[name] = _like(cache[name])
    pos_rows = None if pos.dim() == 0 else position_rows(plan, pos)

    def one(d: int) -> torch.Tensor:
        at = _Position(cfg, plan, d, b)
        tok = position_rows(plan, tokens)[d][0]
        pd = pos.to(at.home) if pos_rows is None else pos_rows[d][0]
        return _decode_position(cfg, p, plan, d, at, tok, pd, cache, new)

    return _gather_logits(plan, _over_positions(plan, one)), new


def _like(x: Any) -> Any:
    """A new, unwritten leaf laid out as ``x``."""
    if is_blocked(x):
        return filled(x.shape, x.dtype, x.sharding, None)
    return torch.empty_like(x)


def _decode_position(cfg: ArchConfig, p: Params, plan: ParallelPlan, d: int,
                     at: _Position, tokens: torch.Tensor, pos: torch.Tensor,
                     cache: Cache, new: Cache) -> torch.Tensor:
    home = at.home
    h = embed_tokens(cfg, {k: take(p[k], home) for k in ("embed",)}, tokens)
    layers = L.unstack_layers(p["layers"], cfg.num_layers)
    qpos = pos.reshape(1, 1) if pos.dim() == 0 else pos[:, None]
    lengths = (pos + 1).expand(at.rows) if pos.dim() == 0 else pos + 1

    def attention(lps: Sequence[Params], x: torch.Tensor, i: int
                  ) -> torch.Tensor:
        alps = [lp["attn"] for lp in lps]
        qkv = [L.qkv_project(cfg, lp, xr, pr) for lp, xr, pr in zip(
            alps, broadcast(x, at.row), broadcast(qpos, at.row))]
        q, k, v = (_heads(cfg, alps, [t[j] for t in qkv], kv=j > 0)
                   for j in range(3))
        for name, val in (("k", k), ("v", v)):
            _write_row(cache[name], at, i, pos, val[:, 0])
        out = _attend(cfg, at, q, cache["k"], cache["v"], i, lengths)
        return _attn_out(cfg, at, alps, out)

    if cfg.family in ATTN_FAMILIES:
        for i, lv in enumerate(layers):
            lps = at.parts(lv)
            h = h + attention(lps, L.rms_norm(h, lps[0]["ln1"], cfg.norm_eps),
                              i)
            h = h + at.ffn(lps, L.rms_norm(h, lps[0]["ln2"], cfg.norm_eps))
    else:
        h0, every = h, cfg.attn_every
        n_apps = cfg.num_layers // every if cfg.family == "hybrid" else 0
        for i, lv in enumerate(layers):
            lps = at.parts(lv)
            x = L.rms_norm(h, lps[0]["ln"], cfg.norm_eps)
            h = h + _mamba_decode(cfg, at, [lp["mamba"] for lp in lps], x,
                                  cache, new, i)
            if n_apps and (i + 1) % every == 0 and i < n_apps * every:
                sps = at.parts(_shared(p), ("shared",))
                x = torch.cat([h, h0], dim=-1) @ take(
                    p["shared"]["w_concat"], home)
                x = x + attention(sps, L.rms_norm(x, sps[0]["ln1"],
                                                  cfg.norm_eps), i // every)
                h = h + x + at.ffn(sps, L.rms_norm(x, sps[0]["ln2"],
                                                   cfg.norm_eps))
    h = L.rms_norm(h, take(p["final_norm"], home), cfg.norm_eps)
    return position_head(cfg, p, plan, d)(h)


def _blocks(x: Any) -> List[Tuple[Region, torch.Tensor]]:
    if is_blocked(x):
        return [(reg, blk) for (reg, _), blk
                in zip(x.sharding.blocks(x.shape), x.blocks)]
    return [(tuple((0, n) for n in x.shape), x)]


def _write_row(leaf: Any, at: _Position, i: int, pos: torch.Tensor,
               val: torch.Tensor) -> None:
    """Write ``val`` ``[rows, kv, hd]``, each row's K or V of the token at
    its ``pos``, into layer ``i`` of a ``[L, b, S, kv, hd]`` cache leaf, in
    place: each block covering the rows takes the rows whose position lies
    in its sequence range (a select, not a mask, so no shape depends on the
    data)."""
    for (lreg, breg, sreg, kreg, dreg), blk in _blocks(leaf):
        (l0, ln), (b0, bn), (s0, sn) = lreg, breg, sreg
        lo, hi = max(b0, at.r0), min(b0 + bn, at.r0 + at.rows)
        if not (l0 <= i < l0 + ln) or lo >= hi:
            continue
        dev = blk.device
        p = pos.to(dev).expand(at.rows)[lo - at.r0:hi - at.r0].long()
        inside = (p >= s0) & (p < s0 + sn)
        local = (p - s0).clamp(0, sn - 1)
        rows = torch.arange(lo - b0, hi - b0, device=dev)
        dst = blk[i - l0]
        old = dst[rows, local]
        v = piece(val, ((lo - at.r0, hi - lo), kreg, dreg), dev)
        dst.index_put_((rows, local), torch.where(inside[:, None, None], v,
                                                  old))


def _attend(cfg: ArchConfig, at: _Position, q: torch.Tensor, kc: Any,
            vc: Any, i: int, lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention of ``q`` ``[rows, 1, h, hd]`` (every head, on the
    first position) over layer ``i`` of the cache, sequence-parallel: each
    model position scores its sequence block in f32 (keys at or past a
    row's length masked) and keeps (max, sum, weighted values); the states
    are merged across the positions.  Returns ``[rows, 1, h, hd]`` in q's
    type."""
    rows, _, h, hd = q.shape
    S, kvh = kc.shape[2], kc.shape[3]
    parts = kc.sharding.parts(kc.ndim)[2] if is_blocked(kc) else 1
    if parts != at.tp:
        parts = 1
    devs = at.row[:parts]
    qs = broadcast(q.reshape(rows, kvh, h // kvh, hd).float(), devs)
    ls = broadcast(lengths, devs)
    ms, sums, outs = [], [], []
    for r, dev in enumerate(devs):
        s0, sn = split_range(S, parts, r)
        reg = ((i, 1), (at.r0, rows), (s0, sn), (0, kvh), (0, hd))
        kb = piece(kc, reg, dev)[0].float()
        vb = piece(vc, reg, dev)[0].float()
        scores = torch.einsum("bkgh,bskh->bkgs", qs[r], kb) * (
            1.0 / math.sqrt(hd))
        valid = (s0 + torch.arange(sn, device=dev))[None, :] < ls[r][:, None]
        scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
        m = scores.amax(dim=-1)
        e = torch.exp(scores - torch.where(torch.isinf(m), 0.0, m)[..., None])
        ms.append(m)
        sums.append(e.sum(dim=-1))
        outs.append(torch.einsum("bkgs,bskh->bkgh", e, vb))
    top = all_gather([m[..., None] for m in ms], dim=-1,
                     axes=AXES).amax(dim=-1)
    ws = [torch.exp(m - t) for m, t in zip(ms, broadcast(top, devs))]
    num = psum([w[..., None] * o for w, o in zip(ws, outs)], AXES)
    den = psum([w * s for w, s in zip(ws, sums)], AXES)
    return (num / den[..., None]).to(q.dtype).reshape(rows, 1, h, hd)


def _mamba_step(cfg: ArchConfig, p: Params, x: torch.Tensor,
                conv: torch.Tensor, ssm: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """One token through the Mamba2 block over the heads ``p`` holds (all,
    or one model position's: ``ssm.mamba_decode_block`` up to its norm):
    (y ``[b, heads · P]`` before the norm, z, the new conv and SSM
    states)."""
    b = x.shape[0]
    H, Pd, N = p["A_log"].shape[0], cfg.ssm_head_dim, cfg.ssm_state
    di = H * Pd
    cdim = di + 2 * cfg.ssm_groups * N
    zxbcdt = x[:, 0] @ p["in_proj"]
    z, xBC, dt = (zxbcdt[..., :di], zxbcdt[..., di:di + cdim],
                  zxbcdt[..., di + cdim:])
    xBC, conv = conv1d_decode(xBC, conv, p["conv_w"], p["conv_b"])
    xs, B, C = xBC[..., :di], xBC[..., di:di + N], xBC[..., di + N:]
    xs = xs.reshape(b, H, Pd)
    y, ssm = ssd_decode_step(xs, softplus_dt(dt, p["dt_bias"]),
                             -torch.exp(p["A_log"]), B, C, ssm)
    y = y + p["D"].to(y.dtype)[None, :, None] * xs
    return y.reshape(b, di), z, conv, ssm


def _mamba_decode(cfg: ArchConfig, at: _Position, lps: Sequence[Params],
                  x: torch.Tensor, cache: Cache, new: Cache, i: int
                  ) -> torch.Tensor:
    """One token through a Mamba2 block across the model positions, each
    reading its channels and heads of layer ``i``'s state from ``cache``
    and writing the stepped state into ``new``."""
    P = cfg.ssm_head_dim
    outs = []
    for r, (lp, xr, dev) in enumerate(zip(lps, broadcast(x, at.row),
                                          at.row)):
        conv = torch.cat([piece(cache["conv"], at.region(
            cache["conv"], i, (0, cache["conv"].shape[2]), c), dev)[0]
            for c in _conv_channels(cfg, r, at.tp)], dim=-1)
        h0, nh = split_range(cfg.ssm_heads, at.tp, r)
        ssm = piece(cache["ssm"], at.region(cache["ssm"], i, (h0, nh)),
                    dev)[0]
        outs.append(_mamba_step(cfg, lp, xr, conv, ssm))
    _put_state(cfg, at, new, i, [o[2] for o in outs], [o[3] for o in outs])
    ys = sharded.gated_rms_norm([o[0] for o in outs], [o[1] for o in outs],
                                [lp["norm_w"] for lp in lps], cfg.norm_eps,
                                cfg.ssm_d_inner)
    return sharded.out_proj_sum(ys, lps)[:, None]
