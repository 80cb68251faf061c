"""Mixture-of-Experts FFN of the port: sort-based capacity dispatch.

Counterparts of ``init_moe``, ``_capacity``, ``moe_apply_local`` and
``moe_block`` (single device and expert-parallel) in
``repro/models/moe.py``:

* The router runs in f32 (its weight is drawn and kept f32 in a bf16
  model); each token takes its top ``K`` experts by softmax probability
  (ties to the lower expert id, as ``lax.top_k``) with the gates
  renormalised over those ``K``.
* Capacity follows GShard: ``C = ceil(n·K/E · capacity_factor)`` over the
  ``n`` tokens of the call.  Assignments are packed expert by expert in
  token order (a stable argsort); those past an expert's ``C`` slots are
  dropped and contribute 0.  The drops depend on the rows of the call, so
  a batch is never padded before it reaches the block.
* The expert FFNs are batched products over ``[E, C, d]`` (``torch.bmm``);
  the combine casts the gates to the model's type and sums over ``K`` in
  f32, rounding once.
* The load-balancing loss is ``E · Σ_e f_e·p_e``.
* Expert parallelism (the JAX package's ``shard_map`` branch of
  ``moe_block``): the experts shard over the tp axis and the router is
  replicated.  Every shard routes every row of the call, packs only its
  own experts ``[e0, e0 + E_loc)`` (:func:`moe_apply_local`'s ``e0``), and
  the shards' f32 outputs are summed (the EP combine is the TP sum) and
  rounded once; ``aux`` is averaged over the shards.  Capacity counts the
  call's rows against the full expert set, so drops and tie-breaks are
  the single device's.
* Data parallelism (``dp_axes``): the batch splits over the data
  positions (contiguous rows, as the JAX package's ``P(dp)``), each
  position routes its own rows with its own capacity over its row of the
  mesh, and ``aux`` is the mean over the data and model positions (the
  GShard convention of the JAX package's ``pmean``).

Nothing here syncs with the host.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.collectives import broadcast, psum
from repro_torch.distributed.mesh import ParallelPlan
from repro_torch.distributed.sharding import shard_leaf
from repro_torch.models import layers as L

Params = Dict[str, Any]


def init_moe(cfg: ArchConfig, gen: torch.Generator,
             dtype: torch.dtype) -> Params:
    """Router ``[d, E]`` in f32, experts ``wu``/``wg`` ``[E, d, f]`` and
    ``wd`` ``[E, f, d]`` in ``dtype`` (no ``wg`` for sqrelu)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p: Params = {
        "router": L.dense_init(gen, (d, e), torch.float32, fan_in=d),
        "wu": L.dense_init(gen, (e, d, f), dtype, fan_in=d),
        "wd": L.dense_init(gen, (e, f, d), dtype, fan_in=f),
    }
    if cfg.mlp_activation in ("swiglu", "geglu"):
        p["wg"] = L.dense_init(gen, (e, d, f), dtype, fan_in=d)
    return p


def _capacity(n_tokens: int, cfg: ArchConfig) -> int:
    e, k = cfg.num_experts, cfg.experts_per_token
    return max(1, int(math.ceil(n_tokens * k / e * cfg.moe_capacity_factor)))


def route(cfg: ArchConfig, x: torch.Tensor, router_w: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The f32 router over x ``[n, d]``: (probs ``[n, E]``, gates ``[n,
    K]`` renormalised over the K, expert ids ``[n, K]``), the ids in
    descending probability with equal ones in index order, as
    ``lax.top_k``."""
    k = cfg.experts_per_token
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    gate, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    gate, expert_ids = gate[:, :k], expert_ids[:, :k]
    return probs, gate / gate.sum(dim=-1, keepdim=True), expert_ids


def moe_apply_local(cfg: ArchConfig, x: torch.Tensor,
                    router_w: torch.Tensor, wg: Optional[torch.Tensor],
                    wu: torch.Tensor, wd: torch.Tensor, e0: int = 0,
                    out_dtype: Optional[torch.dtype] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch, expert FFNs and combine for the experts ``[e0, e0 +
    E_loc)`` held in ``wu``/``wg``/``wd``.  x: ``[n, d]``.  Returns (y
    ``[n, d]`` in ``out_dtype``, x's type by default, the f32 aux loss)."""
    n, d = x.shape
    e_total, k = cfg.num_experts, cfg.experts_per_token
    e_loc = wu.shape[0]
    cap = _capacity(n, cfg)
    nk = n * k
    dev = x.device

    # --- routing over the full expert set ---------------------------------
    probs, gate, expert_ids = route(cfg, x, router_w)
    a_exp = expert_ids.reshape(-1)
    f_e = torch.zeros(e_total, dtype=torch.float32, device=dev).index_add_(
        0, a_exp, torch.full((nk,), 1.0 / nk, dtype=torch.float32,
                             device=dev))
    aux = e_total * torch.sum(f_e * probs.mean(dim=0))

    # --- pack the local assignments into [E_loc, cap] slots ---------------
    a_tok = torch.arange(n, device=dev).repeat_interleave(k)       # [nK]
    a_gate = gate.reshape(-1)
    lexp = a_exp - e0
    is_local = (lexp >= 0) & (lexp < e_loc)
    sort_key = torch.where(is_local, lexp, torch.full_like(lexp, e_loc))
    order = torch.argsort(sort_key, stable=True)   # token order per expert
    key_s = sort_key[order]
    counts = torch.zeros(e_loc + 1, dtype=torch.long, device=dev)
    counts.scatter_add_(0, sort_key, torch.ones_like(sort_key))
    starts = torch.cumsum(counts, dim=0) - counts
    pos_s = torch.arange(nk, device=dev) - starts[key_s]
    keep_s = (pos_s < cap) & (key_s < e_loc)
    dump = e_loc * cap
    slot_s = torch.where(keep_s, key_s * cap + pos_s,
                         torch.full_like(pos_s, dump))
    # slot -> token (the dump slot takes every dropped write and is cut)
    slot_tok = torch.full((dump + 1,), n, dtype=torch.long, device=dev)
    slot_tok[slot_s] = a_tok[order]
    x_pad = torch.cat([x, x.new_zeros(1, d)])
    xb = x_pad[slot_tok[:-1]].reshape(e_loc, cap, d)

    # --- expert FFNs as batched products ----------------------------------
    up = torch.bmm(xb, wu)
    act = cfg.mlp_activation
    if act == "swiglu":
        h = F.silu(torch.bmm(xb, wg)) * up
    elif act == "geglu":
        h = F.gelu(torch.bmm(xb, wg), approximate="tanh") * up
    elif act == "sqrelu":
        h = torch.square(F.relu(up))
    else:
        raise ValueError(f"unknown activation {act}")
    yb = torch.bmm(h, wd).reshape(dump, d)

    # --- combine: each assignment's result times its gate, summed over K
    # in f32 (the gate in the model's type first), rounded once
    slot_a = torch.empty(nk, dtype=torch.long, device=dev)
    slot_a[order] = slot_s
    y_pad = torch.cat([yb, yb.new_zeros(1, d)])
    y_a = y_pad[slot_a].reshape(n, k, d)
    w_a = torch.where(slot_a < dump, a_gate,
                      torch.zeros_like(a_gate)).reshape(n, k)
    y = torch.einsum("nkd,nk->nd", y_a.float(), w_a.to(y_a.dtype).float())
    return y.to(out_dtype or x.dtype), aux


def moe_apply_sharded(cfg: ArchConfig, parts: Sequence[Params],
                      xs: Sequence[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel FFN: shard ``r`` holds the experts of
    ``parts[r]`` (contiguous, in shard order) and the replicated router,
    and ``xs[r]`` ``[n, d]`` is the call's rows on its device.  Returns (the
    shards' outputs summed on the first shard's device, the mean aux).
    Each shard's combine stays in f32 and the sum is rounded once to x's
    type, as one device's combine is."""
    ys, auxes, e0 = [], [], 0
    for p, x in zip(parts, xs):
        y, aux = moe_apply_local(cfg, x, p["router"], p.get("wg"), p["wu"],
                                 p["wd"], e0, out_dtype=torch.float32)
        ys.append(y)
        auxes.append(aux)
        e0 += p["wu"].shape[0]
    return (psum(ys, ("model",)).to(xs[0].dtype),
            psum(auxes, ("model",)) / len(auxes))


def moe_block(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
              mesh: Any = None, dp_axes: Tuple[str, ...] = (),
              tp_axis: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN over ``x`` ``[b, s, d]``: every token of the call routed
    together.  With a mesh and its ``tp_axis``, the experts of ``p`` shard
    over that axis's devices (:func:`moe_apply_sharded`); with ``dp_axes``
    too, each data position routes its rows of the batch over its row of
    the mesh.  The result lands on ``x``'s device.  Returns (y ``[b, s,
    d]``, aux)."""
    b, s, d = x.shape
    if mesh is None or tp_axis is None:
        y, aux = moe_apply_local(cfg, x.reshape(-1, d), p["router"],
                                 p.get("wg"), p["wu"], p["wd"])
        return y.reshape(b, s, d), aux
    plan = ParallelPlan(mesh=mesh, dp_axes=tuple(dp_axes), tp_axis=tp_axis)
    tp, n_dp = plan.tp_size, plan.dp_size
    if cfg.num_experts % tp:
        raise ValueError(f"{cfg.num_experts} experts must divide tp={tp}")
    if b % n_dp:
        raise ValueError(f"batch {b} does not split over {n_dp} data "
                         "positions")
    rows = b // n_dp
    ys, auxes = [], []
    for i, devices in enumerate(plan.grid):
        parts = [{k: shard_leaf(v, (None,) if k == "router" else (tp_axis,),
                                tp_axis, r, tp, dev) for k, v in p.items()}
                 for r, dev in enumerate(devices)]
        x_i = x[i * rows:(i + 1) * rows].reshape(-1, d)
        y, aux = moe_apply_sharded(cfg, parts, broadcast(x_i, devices))
        ys.append(y.reshape(rows, s, d).to(x.device))
        auxes.append(aux.to(x.device))
    return torch.cat(ys), psum(auxes, plan.dp_axes) / n_dp


def ffn(cfg: ArchConfig, lp: Params, x: torch.Tensor) -> torch.Tensor:
    """The post-attention FFN of one layer on the ln2-normed ``x``: the MoE
    block of an MoE config (its aux loss dropped, as serving does), else
    the MLP."""
    if cfg.is_moe:
        return moe_block(cfg, lp["moe"], x)[0]
    return L.mlp_block(cfg, lp["mlp"], x)
