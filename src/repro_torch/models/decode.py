"""Prefill and one-token decode of the port's families.

Counterparts of ``decode_state_specs``, ``init_decode_state``, ``prefill``
and ``decode_step`` in ``repro/models/decode.py``:

* dense, vlm, audio, moe: the prefill returns the last-position logits and
  the contiguous decode cache ``{"k", "v": [L, b, max_len, kv, hd]}``, zero
  past the prompt; an MoE layer's FFN is the MoE block over every token of
  the call (``models/moe.py``).  Attention goes through the flash
  attention kernel
  (:func:`repro_torch.kernels.flash_attention.flash_attention`), where the
  JAX package computes the same function with jnp.  The VLM stub's
  ``frontend_embed`` fills the first positions; audio tokens are ``[b, s,
  cb]`` and its logits ``[b, s, cb, V]``.  :func:`decode_step` writes the
  new token's K/V row **into the cache it is given** (a scalar ``pos``
  writes one row for the whole batch, a ``[b]`` ``pos`` scatters) and
  attends with plain torch ops, as the JAX package does with jnp; paged
  serving of these families runs in ``runtime/serve_loop.py`` instead.
* ssm: the prefill returns the decode cache ``{"conv": [L, b, ck-1,
  conv_dim], "ssm": [L, b, H, N, P] f32}``; its scan is the SSD scan kernel
  (:func:`repro_torch.kernels.ssd_scan.ssd_scan`), where the JAX package
  uses the jnp ``ssd_chunked``.  :func:`decode_step` advances the cache by
  one token **out of place**: it returns new tensors and never writes into
  the cache it was given, so a cache shared by reference between branches
  (``BranchStore`` snapshots) is never changed under a sibling.
* hybrid: the cache is the SSM's plus ``{"k", "v": [A, b, max_len, kv,
  hd]}``, one KV cache per application of the shared attention block (A =
  ``num_layers // attn_every``: the weights are shared, the KV is not).
  The prefill runs each group of ``attn_every`` Mamba2 layers (the SSD scan
  kernel), then the shared block on ``concat([h, h0]) @ w_concat`` (``h0``
  the embedding output; its attention is the flash attention kernel at the
  config's head dim, 112 for ``zamba2-7b``), then the
  ``num_layers % attn_every`` tail layers.  Its :func:`decode_step` mixes
  the two contracts: ``conv``/``ssm`` are stepped **out of place**, as for
  the SSM, while the token's K/V row is written **into the** ``k``/``v``
  **it is given**, as for the dense families.  A hybrid cache restored from
  a ``BranchStore`` must therefore be batched by ``torch.cat`` or cloned
  before it is stepped; stepped as restored, the store refuses the next
  read of the leaves it wrote into.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.moe import ffn
from repro_torch.models.ssm import mamba_decode_block, mamba_forward
from repro_torch.models.transformer import (
    ATTN_FAMILIES,
    SSM_FAMILIES,
    embed_tokens,
    lm_head,
    torch_dtype,
)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------

def decode_state_specs(cfg: ArchConfig, batch: int, max_len: int
                       ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of a decode cache: contiguous K/V for
    the attention families, the recurrent state for SSM (``max_len``
    unused: the state does not grow), both for the hybrid (K/V per shared
    block application)."""
    dt = torch_dtype(cfg)
    out: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    kv_shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    if cfg.family in ATTN_FAMILIES:
        out["k"] = out["v"] = ((cfg.num_layers, *kv_shape), dt)
    elif cfg.family in SSM_FAMILIES:
        ck, cdim = cfg.ssm_conv_kernel, cfg.ssm_conv_dim
        H, N, Pd = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
        out["conv"] = ((cfg.num_layers, batch, ck - 1, cdim), dt)
        out["ssm"] = ((cfg.num_layers, batch, H, N, Pd), torch.float32)
        if cfg.family == "hybrid":
            n_apps = cfg.num_layers // cfg.attn_every
            out["k"] = out["v"] = ((n_apps, *kv_shape), dt)
    else:
        raise NotImplementedError(f"no decode cache for family {cfg.family}")
    return out


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device: Any = None) -> Dict[str, torch.Tensor]:
    """A zero decode cache on ``device`` (``cuda`` unless given)."""
    device = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, (shape, dtype)
            in decode_state_specs(cfg, batch, max_len).items()}


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def prefill(cfg: ArchConfig, p: Params, tokens: torch.Tensor,
            frontend_embed: Optional[torch.Tensor] = None, *,
            max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens ``[b, s]`` (``[b, s, cb]`` for audio) -> (last-position
    logits ``[b, 1, V]`` or ``[b, 1, cb, V]``, cache).

    Dense, vlm, audio, moe: the cache holds ``"k"``/``"v"`` as ``[L, b,
    max_len, kv, hd]``, zero past ``s``; ``frontend_embed`` ``[b, n, d]``
    (VLM stub) fills positions ``[0, n)``.  SSM: ``"conv"``/``"ssm"``
    (``max_len`` unused).  Hybrid: both, ``"k"``/``"v"`` as ``[A, b,
    max_len, kv, hd]``.
    """
    if cfg.family in SSM_FAMILIES:
        return _ssm_prefill(cfg, p, tokens, max_len)
    b, s = tokens.shape[:2]
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} < prompt length {s}")
    h = embed_tokens(cfg, p, tokens, frontend_embed)
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
        h = h + ffn(cfg, lp, x)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    h = L.rms_norm(h[:, -1:], p["final_norm"], cfg.norm_eps)
    return lm_head(cfg, p, h), cache


def _ssm_prefill(cfg: ArchConfig, p: Params, tokens: torch.Tensor,
                 max_len: Optional[int]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The SSM and hybrid prefill: the Mamba2 layers in order, and for the
    hybrid the shared block after every ``attn_every`` of them."""
    b, s = tokens.shape[:2]
    if s < cfg.ssm_conv_kernel - 1:
        # the conv state is the last ck - 1 inputs; a shorter prompt would
        # give a state of the wrong shape (the JAX package does not check)
        raise ValueError(f"an SSM prompt needs at least "
                         f"{cfg.ssm_conv_kernel - 1} tokens, got {s}")
    h = embed_tokens(cfg, p, tokens)
    cache: Dict[str, torch.Tensor] = {}
    hybrid = cfg.family == "hybrid"
    if hybrid:
        max_len = max_len or s
        if max_len < s:
            raise ValueError(f"max_len {max_len} < prompt length {s}")
        h0 = h
        positions = torch.arange(s, device=tokens.device)
        every = cfg.attn_every
        n_apps = cfg.num_layers // every
        for name in ("k", "v"):
            cache[name] = torch.zeros((n_apps, b, max_len, cfg.num_kv_heads,
                                       cfg.head_dim), dtype=h.dtype,
                                      device=h.device)
    convs, ssms = [], []
    for i in range(cfg.num_layers):
        lp = L.layer_params(p["layers"], i)
        x = L.rms_norm(h, lp["ln"], cfg.norm_eps)
        y, conv, ssm = mamba_forward(cfg, lp["mamba"], x)
        h = h + y
        convs.append(conv.contiguous())
        ssms.append(ssm)
        if hybrid and (i + 1) % every == 0 and i < n_apps * every:
            h, k, v = _shared_prefill(cfg, p["shared"], h, h0, positions)
            cache["k"][i // every, :, :s] = k
            cache["v"][i // every, :, :s] = v
    h = L.rms_norm(h[:, -1:], p["final_norm"], cfg.norm_eps)
    cache["conv"] = torch.stack(convs)
    cache["ssm"] = torch.stack(ssms)
    return lm_head(cfg, p, h), cache


def _shared_prefill(cfg: ArchConfig, sp: Params, h: torch.Tensor,
                    h0: torch.Tensor, positions: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The hybrid's shared attention + MLP block over the prompt, on
    ``concat([h, h0]) @ w_concat``; attention through the flash attention
    kernel.  Returns (h + x + m, k, v)."""
    x = torch.cat([h, h0], dim=-1) @ sp["w_concat"]
    xa = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
    q, k, v = L.qkv_project(cfg, sp["attn"], xa, positions)
    x = x + L.attn_out(flash_attention(q, k, v), sp["attn"]["wo"])
    m = L.mlp_block(cfg, sp["mlp"], L.rms_norm(x, sp["ln2"], cfg.norm_eps))
    return h + x + m, k, v


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def decode_step(cfg: ArchConfig, p: Params, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One new token for every sequence; returns (logits ``[b, 1, V]`` or
    ``[b, 1, cb, V]``, the cache).  ``tokens`` ``[b, 1]`` (``[b, 1, cb]``
    for audio).

    Dense, vlm, audio, moe: ``pos`` is a scalar (aligned batch) or ``[b]``;
    the token's K/V row is written into ``cache`` in place and the same
    tensors are returned (a cache restored from a ``BranchStore`` is shared
    with its siblings: clone it first, or the store refuses its next
    read).  SSM: ``pos`` is unused by the recurrence (kept for the JAX
    signature) and the step is out of place: new tensors are returned.
    Hybrid: ``conv``/``ssm`` out of place, as for the SSM; ``k``/``v`` in
    place, as for the dense families (``pos`` places the row), so a
    restored hybrid cache is batched by ``torch.cat`` or cloned first; the
    shared block's ``h0`` is the current token's embedding.
    """
    if cfg.family not in ATTN_FAMILIES + SSM_FAMILIES:
        raise NotImplementedError(f"no decode step for family {cfg.family}")
    h = embed_tokens(cfg, p, tokens)
    new_cache = dict(cache)
    if cfg.family in ATTN_FAMILIES:
        for i in range(cfg.num_layers):
            lp = L.layer_params(p["layers"], i)
            x = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
            a, _, _ = L.attention_decode_block(cfg, lp["attn"], x, pos,
                                               cache["k"][i], cache["v"][i])
            h = h + a
            x = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
            h = h + ffn(cfg, lp, x)
    else:
        # fresh tensors, filled layer by layer: the input state is only read
        new_cache["conv"] = torch.empty_like(cache["conv"])
        new_cache["ssm"] = torch.empty_like(cache["ssm"])
        h0 = h
        every = cfg.attn_every
        n_apps = cfg.num_layers // every if cfg.family == "hybrid" else 0
        for i in range(cfg.num_layers):
            lp = L.layer_params(p["layers"], i)
            x = L.rms_norm(h, lp["ln"], cfg.norm_eps)
            y, conv, ssm = mamba_decode_block(cfg, lp["mamba"], x,
                                              cache["conv"][i],
                                              cache["ssm"][i])
            new_cache["conv"][i] = conv
            new_cache["ssm"][i] = ssm
            h = h + y
            if n_apps and (i + 1) % every == 0 and i < n_apps * every:
                h = _shared_decode(cfg, p["shared"], h, h0, pos,
                                   cache["k"][i // every],
                                   cache["v"][i // every])
    h = L.rms_norm(h, p["final_norm"], cfg.norm_eps)
    return lm_head(cfg, p, h), new_cache


def _shared_decode(cfg: ArchConfig, sp: Params, h: torch.Tensor,
                   h0: torch.Tensor, pos: torch.Tensor,
                   k_cache: torch.Tensor, v_cache: torch.Tensor
                   ) -> torch.Tensor:
    """One token through the hybrid's shared block, its K/V row written
    into this application's ``k_cache``/``v_cache``; attention in plain
    torch ops over the contiguous cache, as the JAX package's jnp."""
    x = torch.cat([h, h0], dim=-1) @ sp["w_concat"]
    xa = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
    a, _, _ = L.attention_decode_block(cfg, sp["attn"], xa, pos, k_cache,
                                       v_cache)
    x = x + a
    m = L.mlp_block(cfg, sp["mlp"], L.rms_norm(x, sp["ln2"], cfg.norm_eps))
    return h + x + m
