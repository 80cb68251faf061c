"""Gradient compression for cross-node reductions, with error feedback.

Two standard compressors (the JAX package's ``repro/optim/compress.py``):

* **int8 per-tensor quantization** — 4x volume reduction on bf16/f32
  gradients; scale = max|g| per leaf.
* **top-k sparsification** — keep the k largest-|g| entries per leaf (the
  order among equal magnitudes is ``torch.topk``'s).

Both keep an **error-feedback** residual (Karimireddy et al.): the
compression error is added back into the next step's gradient, preserving
convergence.  ``compressed_gradients`` is dtype/shape-preserving so it
drops into the train step where a cross-node reduction would sit.  A leaf
stored as blocks (``distributed.blocked.Blocked``) is compressed as the
whole leaf: int8's scale is the max over its blocks, top-k's k largest
are chosen among its blocks' own k largest.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.distributed.blocked import Blocked, is_blocked
from repro_torch.optim.base import zeros_f32


class ErrorFeedbackState(NamedTuple):
    residual: Any  # tree like grads, f32


def ef_init(grads_like: Any) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual=zeros_f32(grads_like))


def int8_quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def int8_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x.float()
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-30
    return int8_quantize(x, scale), scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_compress(x: torch.Tensor, frac: float = 0.01
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (values, flat indices) of the k largest-|x| entries."""
    flat = x.float().reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    _, idx = torch.topk(torch.abs(flat), k)
    return flat[idx], idx


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor, shape
                    ) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    return torch.zeros(n, dtype=torch.float32, device=vals.device).scatter(
        0, idx, vals).reshape(shape)


def _topk_blocks(xs: List[torch.Tensor], frac: float) -> List[torch.Tensor]:
    """Top-k of a leaf stored as the f32 blocks ``xs``, reconstructed block
    by block: k counts the whole leaf; each block's own k largest |x| are
    the candidates, and the k largest of those (chosen on the first
    block's device) are kept."""
    n = sum(x.numel() for x in xs)
    k = max(1, int(n * frac))
    cands = [torch.topk(torch.abs(x.reshape(-1)), min(k, x.numel()))[1]
             for x in xs]
    home = xs[0].device
    mags = torch.cat([torch.abs(x.reshape(-1)[i]).to(home)
                      for x, i in zip(xs, cands)])
    keep = torch.zeros(mags.shape[0], dtype=torch.bool, device=home)
    keep[torch.topk(mags, k)[1]] = True
    out, at = [], 0
    for x, i in zip(xs, cands):
        sel = i[keep[at:at + i.numel()].to(x.device)]
        at += i.numel()
        out.append(topk_decompress(x.reshape(-1)[sel], sel, x.shape))
    return out


def compressed_gradients(grads: Any, ef: ErrorFeedbackState, *,
                         method: str = "int8", topk_frac: float = 0.01
                         ) -> Tuple[Any, ErrorFeedbackState]:
    """Compress + decompress grads with error feedback: the returned
    gradients are what the receiving side reconstructs; the residual
    carries this step's compression error into the next step."""
    def one(g: torch.Tensor, r: torch.Tensor):
        g32 = g.float() + r
        if method == "int8":
            recon = int8_decompress(*int8_compress(g32))
        elif method == "topk":
            vals, idx = topk_compress(g32, topk_frac)
            recon = topk_decompress(vals, idx, g32.shape)
        elif method == "none":
            recon = g32
        else:
            raise ValueError(method)
        return recon.to(g.dtype), g32 - recon

    def blocked(g: Blocked, r: Blocked):
        g32 = [x.float() + y for x, y in zip(g.blocks, r.blocks)]
        if method == "int8":
            scale = torch.stack([torch.max(torch.abs(x)).to(g32[0].device)
                                 for x in g32]).max() / 127.0 + 1e-30
            recon = [int8_decompress(int8_quantize(x, scale.to(x.device)),
                                     scale.to(x.device)) for x in g32]
        elif method == "topk":
            recon = _topk_blocks(g32, topk_frac)
        elif method == "none":
            recon = g32
        else:
            raise ValueError(method)
        return (Blocked([x.to(g.dtype) for x in recon], g.sharding, g.shape),
                Blocked([a - b for a, b in zip(g32, recon)], r.sharding,
                        r.shape))

    flat, spec = pytree.tree_flatten(grads, is_leaf=is_blocked)
    res = pytree.tree_leaves(ef.residual, is_leaf=is_blocked)
    outs = [blocked(g, r) if is_blocked(g) else one(g, r)
            for g, r in zip(flat, res)]
    return (pytree.tree_unflatten([o[0] for o in outs], spec),
            ErrorFeedbackState(residual=pytree.tree_unflatten(
                [o[1] for o in outs], spec)))


def compression_ratio(method: str, dtype: torch.dtype = torch.bfloat16,
                      topk_frac: float = 0.01) -> float:
    """Payload bytes ratio vs uncompressed."""
    bits = torch.finfo(dtype).bits
    if method == "int8":
        return 8.0 / bits
    if method == "topk":
        return topk_frac * (32 + 32) / bits
    return 1.0


__all__ = ["ErrorFeedbackState", "compressed_gradients", "compression_ratio",
           "ef_init", "int8_compress", "int8_decompress", "topk_compress",
           "topk_decompress"]
