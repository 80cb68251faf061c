"""Parameters, embedding and output head of the port's two families.

Counterparts of ``init_transformer`` (dense and ssm branches),
``embed_tokens`` and ``lm_head`` in ``repro/models/transformer.py``.
Parameters are a plain dict of tensors in the JAX package's layout, layers
stacked ``[L, ...]``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.ssm import init_mamba

Params = Dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def check_servable(cfg: ArchConfig) -> None:
    """The port serves the single-codebook swiglu dense family and the
    attention-free SSM (Mamba2) family."""
    if cfg.family == "ssm" and cfg.ssm_groups == 1:
        return
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name} (hybrid): the shared-attention hybrid family is "
            "not ported yet (ROADMAP queue 1, the hybrid family)")
    if (cfg.family != "dense" or cfg.is_moe or cfg.num_codebooks > 1
            or cfg.frontend != "none" or cfg.mlp_activation != "swiglu"):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}, {cfg.mlp_activation}): the port "
            "serves the swiglu dense family and the SSM family; MoE, VLM "
            "and audio are ROADMAP queue 1")


def init_transformer(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Random weights drawn from ``gen`` on its device."""
    check_servable(cfg)
    dtype = torch_dtype(cfg)
    dev = gen.device
    d, n = cfg.d_model, cfg.num_layers
    p: Params = {"embed": L.dense_init(gen, (cfg.vocab_size, d), dtype,
                                       fan_in=d)}
    layers = []
    for _ in range(n):
        if cfg.family == "ssm":
            layers.append({
                "ln": torch.ones((d,), dtype=dtype, device=dev),
                "mamba": init_mamba(cfg, gen, dtype),
            })
            continue
        layers.append({
            "ln1": torch.ones((d,), dtype=dtype, device=dev),
            "ln2": torch.ones((d,), dtype=dtype, device=dev),
            "attn": L.init_attention(cfg, gen, dtype),
            "mlp": L.init_mlp(cfg, gen, dtype),
        })
    p["layers"] = _stack(layers)
    p["final_norm"] = torch.ones((d,), dtype=dtype, device=dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, (d, cfg.vocab_size), dtype,
                                    fan_in=d)
    return p


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    out = torch.stack(trees)
    trees.clear()         # drop the per-layer copies as soon as stacked
    return out


def embed_tokens(cfg: ArchConfig, p: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    """tokens [b, s] -> hidden [b, s, d]."""
    return p["embed"][tokens]


def lm_head(cfg: ArchConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    """h: [b, s, d] -> logits [b, s, V]."""
    if cfg.tie_embeddings:
        return h @ p["embed"].T
    return h @ p["lm_head"]
