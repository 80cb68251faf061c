"""Dense transformer layers of the port: norm, rotary, GQA projection, MLP.

Counterparts of ``repro/models/layers.py``.  Parameters keep the JAX
package's layout (``wq`` is ``[d, h, hd]``, ``wo`` is ``[h, hd, d]``, ...)
so weights cross between the packages unchanged; layer parameters are
stacked ``[L, ...]`` and :func:`layer_params` slices one layer out.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# initialization helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Tuple[int, ...],
               dtype: torch.dtype, fan_in: Optional[int] = None
               ) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights, drawn in float32 on ``gen``'s device."""
    if fan_in is None:
        fan_in = shape[-2] if len(shape) > 1 else shape[-1]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


def layer_params(p: Any, i: int) -> Any:
    """Layer ``i`` of a stacked ``[L, ...]`` parameter tree (views)."""
    if isinstance(p, dict):
        return {k: layer_params(v, i) for k, v in p.items()}
    return p[i]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(x.dtype)


def gated_rms_norm(x: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Mamba2's output norm: RMSNorm(x * silu(z)), in f32, rounded once."""
    xf = x.float() * F.silu(z.float())
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding (split-half rotation)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs       # [..., s, hd/2]
    cos = torch.cos(angles)[..., :, None, :]               # [..., s, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention projections and MLP
# ---------------------------------------------------------------------------

def init_attention(cfg: ArchConfig, gen: torch.Generator,
                   dtype: torch.dtype) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p: Params = {
        "wq": dense_init(gen, (d, h, hd), dtype, fan_in=d),
        "wk": dense_init(gen, (d, kv, hd), dtype, fan_in=d),
        "wv": dense_init(gen, (d, kv, hd), dtype, fan_in=d),
        "wo": dense_init(gen, (h, hd, d), dtype, fan_in=h * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=gen.device)
        p["bk"] = torch.zeros((kv, hd), dtype=dtype, device=gen.device)
        p["bv"] = torch.zeros((kv, hd), dtype=dtype, device=gen.device)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).unflatten(-1, (h, hd))


def qkv_project(cfg: ArchConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [b, s, d] -> q [b, s, h, hd], k/v [b, s, kv, hd] (rope applied)."""
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.contiguous()


def attn_out(a: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, hd, d = wo.shape
    return a.reshape(*a.shape[:-2], h * hd) @ wo.reshape(h * hd, d)


def init_mlp(cfg: ArchConfig, gen: torch.Generator,
             dtype: torch.dtype) -> Params:
    """SwiGLU weights (the only activation of the served configs)."""
    d, f = cfg.d_model, cfg.d_ff
    return {"wu": dense_init(gen, (d, f), dtype),
            "wd": dense_init(gen, (f, d), dtype),
            "wg": dense_init(gen, (d, f), dtype)}


def mlp_block(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: (silu(x wg) * (x wu)) wd."""
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
