"""Plain reference of a decoder-only transformer, dense or with sparse
experts, in float32.

It follows the layer equations of the configurations the benchmark runs
(``configs/*.json``, ``model``): pre-norm RMSNorm blocks, rotary positions
(split-half rotation), grouped-query causal attention scaled by
``1/sqrt(head_dim)``, a gated MLP (SwiGLU: ``silu(x wg) * (x wu) wd``;
GeGLU with gelu's tanh form) or ``experts`` of them behind a softmax router
whose top ``experts_per_token`` gates are renormalised over those chosen,
every routed token computed (no capacity, no drop), a final RMSNorm and the
head (``lm_head``, or the embedding's transpose where ``tie_embeddings``).
Where ``qkv_bias`` is set, q, k and v each add their bias before the
rotation.  Weights are the benchmark's own tensors in the layout
``[layers, ...]`` (``wq`` ``[d, h, hd]``, ``bq`` ``[h, hd]``, ``wo``
``[h, hd, d]``, ``wu`` ``[d, f]``, experts ``[E, d, f]``, router
``[d, E]``), the embedding ``[V, d]``.

Everything runs in float32 with TF32 off, layer by layer over all the
sequences, so that one layer's weights are widened once.  ``precision``
names the control: every matrix product's operands rounded to a lower type
first (``bfloat16``, or ``float8``: e4m3 with a scale per weight column
and per activation row), the product and all else as before.

It imports torch and nothing else of this repository."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import torch
import torch.nn.functional as F

#: the control's precision for each configured type: the next one below
LOWER = {"float32": "bfloat16", "bfloat16": "float8"}

#: query rows per attention block; feed-forward rows per block
ATTN_ROWS = 512
FFN_ROWS = 4096

E4M3_MAX = 448.0


def set_exact() -> None:
    """float32 products stay float32 (no TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round(x: torch.Tensor, precision: str, dim: int) -> torch.Tensor:
    """``x`` rounded to ``precision`` and widened back to float32; float8
    scales each slice along ``dim`` by its largest magnitude."""
    if precision == "float32":
        return x
    if precision == "bfloat16":
        return x.to(torch.bfloat16).float()
    if precision == "float8":
        s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
        return (x / s).to(torch.float8_e4m3fn).float() * s
    raise ValueError(f"unknown precision {precision!r}")


class _Linear:
    """A weight ``[k, n]`` widened once (and rounded for the control)."""

    def __init__(self, w: torch.Tensor, precision: str):
        self.precision = precision
        self.w = _round(w.float(), precision, dim=0)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _round(x, self.precision, dim=-1) @ self.w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x ``[s, heads, hd]`` at positions 0..s-1; angles in float64."""
    s, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """q ``[s, h, hd]``, k/v ``[s, kv, hd]`` -> ``[s, h, hd]``."""
    s, h, hd = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    for c0 in range(0, s, ATTN_ROWS):
        c1 = min(s, c0 + ATTN_ROWS)
        sc = torch.einsum("qhd,khd->hqk", q[c0:c1], k[:c1]) / math.sqrt(hd)
        mask = (torch.arange(c1, device=q.device)[None, :]
                > torch.arange(c0, c1, device=q.device)[:, None])
        sc.masked_fill_(mask, float("-inf"))
        out[c0:c1] = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1),
                                  v[:c1])
    return out


def _act(m: Dict[str, Any], gate: torch.Tensor) -> torch.Tensor:
    if m["mlp_activation"] == "swiglu":
        return F.silu(gate)
    if m["mlp_activation"] == "geglu":
        return F.gelu(gate, approximate="tanh")
    raise ValueError(f"unknown activation {m['mlp_activation']}")


def mlp(m: Dict[str, Any], p: Dict[str, torch.Tensor], x: torch.Tensor,
        precision: str) -> torch.Tensor:
    wg, wu, wd = (_Linear(p[n], precision) for n in ("wg", "wu", "wd"))
    out = torch.empty_like(x)
    for r0 in range(0, x.shape[0], FFN_ROWS):
        xr = x[r0:r0 + FFN_ROWS]
        out[r0:r0 + FFN_ROWS] = wd(_act(m, wg(xr)) * wu(xr))
    return out


def experts(m: Dict[str, Any], p: Dict[str, torch.Tensor], x: torch.Tensor,
            precision: str) -> torch.Tensor:
    """Softmax router in float32, top-k gates renormalised, every token
    computed by each expert it is routed to."""
    k = m["experts_per_token"]
    probs = torch.softmax(x @ p["router"].float(), dim=-1)
    gate, ids = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(m["num_experts"]):
        rows, slot = torch.nonzero(ids == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = mlp(m, {n: p[n][e] for n in ("wg", "wu", "wd")}, x[rows],
                precision)
        out.index_add_(0, rows, y * gate[rows, slot, None])
    return out


def _project(a: Dict[str, torch.Tensor], n: str, x: torch.Tensor,
             precision: str, bias: bool) -> torch.Tensor:
    """x ``[rows, d]`` through ``w<n>`` ``[d, heads, hd]`` (and ``b<n>``)
    -> ``[rows, heads * hd]``."""
    w = a["w" + n]
    y = _Linear(w.reshape(w.shape[0], -1), precision)(x)
    return y + a["b" + n].reshape(-1).float() if bias else y


def score(m: Dict[str, Any], weights: Dict[str, Any],
          seqs: Sequence[Sequence[int]], starts: Sequence[int], *,
          precision: str = "float32") -> List[torch.Tensor]:
    """Float32 logits ``[len(seq) - start, vocab]`` of each sequence at its
    positions ``start ..``: row ``j`` predicts token ``start + j + 1``.
    The sequences' rows are stacked for every position-wise product; only
    attention runs sequence by sequence."""
    set_exact()
    dev = weights["embed"].device
    eps = m.get("norm_eps", 1e-5)
    hd = m.get("head_dim") or m["d_model"] // m["num_heads"]
    lens = [len(s) for s in seqs]
    offs = [sum(lens[:j]) for j in range(len(lens) + 1)]
    ids = torch.tensor([t for s in seqs for t in s], device=dev)
    h = weights["embed"][ids].float()
    layers = weights["layers"]
    for i in range(m["num_layers"]):
        lp = {k: ({n: t[i] for n, t in v.items()} if isinstance(v, dict)
                  else v[i]) for k, v in layers.items()}
        a = lp["attn"]
        x = rms_norm(h, lp["ln1"], eps)
        q, kk, vv = (_project(a, n, x, precision, m.get("qkv_bias"))
                     .view(x.shape[0], -1, hd) for n in ("q", "k", "v"))
        del x
        o = torch.cat([
            causal_attention(rope(q[o0:o1], m["rope_theta"]),
                             rope(kk[o0:o1], m["rope_theta"]), vv[o0:o1])
            for o0, o1 in zip(offs[:-1], offs[1:])]).reshape(h.shape[0], -1)
        del q, kk, vv
        h = h + _Linear(a["wo"].reshape(-1, a["wo"].shape[-1]), precision)(o)
        del o
        x = rms_norm(h, lp["ln2"], eps)
        if m.get("num_experts"):
            h = h + experts(m, lp["moe"], x, precision)
        else:
            h = h + mlp(m, lp["mlp"], x, precision)
        del x
    head = _Linear(weights["embed"].T if m.get("tie_embeddings")
                   else weights["lm_head"], precision)
    return [head(rms_norm(h[o0 + st:o1], weights["final_norm"], eps))
            for o0, o1, st in zip(offs[:-1], offs[1:], starts)]


def gaps(logits: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    """By how much each token's logit lies below the row's best."""
    t = torch.tensor(list(tokens), device=logits.device)
    return logits.max(-1).values - logits.gather(1, t[:, None])[:, 0]
