"""Gradient compression for cross-node reductions, with error feedback.

Two standard compressors (the JAX package's ``repro/optim/compress.py``):

* **int8 per-tensor quantization** — 4x volume reduction on bf16/f32
  gradients; scale = max|g| per leaf.
* **top-k sparsification** — keep the k largest-|g| entries per leaf (the
  order among equal magnitudes is ``torch.topk``'s).

Both keep an **error-feedback** residual (Karimireddy et al.): the
compression error is added back into the next step's gradient, preserving
convergence.  ``compressed_gradients`` is dtype/shape-preserving so it
drops into the train step where a cross-node reduction would sit.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.optim.base import map_leaves, zeros_f32


class ErrorFeedbackState(NamedTuple):
    residual: Any  # tree like grads, f32


def ef_init(grads_like: Any) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual=zeros_f32(grads_like))


def int8_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x.float()
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


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


def compressed_gradients(grads: Any, ef: ErrorFeedbackState, *,
                         method: str = "int8", topk_frac: float = 0.01
                         ) -> Tuple[Any, ErrorFeedbackState]:
    """Compress + decompress grads with error feedback: the returned
    gradients are what the receiving side reconstructs; the residual
    carries this step's compression error into the next step."""
    def one(g, r):
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

    out, res = map_leaves(one, grads, ef.residual)
    return out, ErrorFeedbackState(residual=res)


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
