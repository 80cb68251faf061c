"""Dense prefill of the port: the prompt's logits and per-layer K/V.

Counterpart of the dense branch of ``prefill`` in
``repro/models/decode.py``.  Attention goes through the flash attention
kernel (:func:`repro_torch.kernels.flash_attention.flash_attention`),
where the JAX package computes the same function with jnp.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.transformer import embed_tokens, lm_head

Params = Dict[str, Any]


def prefill(cfg: ArchConfig, p: Params, tokens: torch.Tensor, *,
            max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens [b, s] -> (last-position logits [b, 1, V], cache).

    The cache holds ``"k"``/``"v"`` as ``[L, b, max_len, kv, hd]``,
    zero past ``s``.
    """
    b, s = tokens.shape
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} < prompt length {s}")
    h = embed_tokens(cfg, p, tokens)
    positions = torch.arange(s, device=tokens.device)
    cache = {name: torch.zeros((cfg.num_layers, b, max_len,
                                cfg.num_kv_heads, cfg.head_dim),
                               dtype=h.dtype, device=h.device)
             for name in ("k", "v")}
    for i in range(cfg.num_layers):
        lp = L.layer_params(p["layers"], i)
        x = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
        q, k, v = L.qkv_project(cfg, lp["attn"], x, positions)
        h = h + L.attn_out(flash_attention(q, k, v), lp["attn"]["wo"])
        x = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
        h = h + L.mlp_block(cfg, lp["mlp"], x)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    h = L.rms_norm(h[:, -1:], p["final_norm"], cfg.norm_eps)
    return lm_head(cfg, p, h), cache
