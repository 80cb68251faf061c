"""Mixture-of-Experts FFN of the port: sort-based capacity dispatch.

Counterparts of ``init_moe``, ``_capacity``, ``moe_apply_local`` and the
single-device ``moe_block`` in ``repro/models/moe.py``:

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

The JAX package's expert-parallel ``shard_map`` branch is multi-GPU work
(ROADMAP §1, multi-GPU): ``moe_block`` raises on a mesh.  Nothing here
syncs with the host.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
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
                    wu: torch.Tensor, wd: torch.Tensor, e0: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch, expert FFNs and combine for the experts ``[e0, e0 +
    E_loc)`` held in ``wu``/``wg``/``wd``.  x: ``[n, d]``.  Returns (y
    ``[n, d]`` in x's type, the f32 aux loss)."""
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
    return y.to(x.dtype), aux


def moe_block(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
              mesh: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN over ``x`` ``[b, s, d]``: every token of the call routed
    together.  Returns (y ``[b, s, d]``, aux)."""
    if mesh is not None:
        raise NotImplementedError(
            "expert-parallel MoE over a mesh is not ported yet (ROADMAP "
            "§1, multi-GPU)")
    b, s, d = x.shape
    y, aux = moe_apply_local(cfg, x.reshape(-1, d), p["router"], p.get("wg"),
                             p["wu"], p["wd"])
    return y.reshape(b, s, d), aux


def ffn(cfg: ArchConfig, lp: Params, x: torch.Tensor) -> torch.Tensor:
    """The post-attention FFN of one layer on the ln2-normed ``x``: the MoE
    block of an MoE config (its aux loss dropped, as serving does), else
    the MLP."""
    if cfg.is_moe:
        return moe_block(cfg, lp["moe"], x)[0]
    return L.mlp_block(cfg, lp["mlp"], x)
