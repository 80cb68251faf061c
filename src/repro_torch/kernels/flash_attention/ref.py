"""Plain PyTorch version of the causal GQA flash attention kernel.

Full-materialisation causal softmax attention with the KV head of query
head ``h`` being ``h // g``.  The wrapper in ``ops.py`` runs it for CPU
tensors; on the card it is what the CUDA kernel is held against.
"""

from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """q: [b, s, h, hd]; k, v: [b, s, kv, hd]; returns [b, s, h, hd]."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    qr = q.float().reshape(b, s, kv, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qr, k.float()) * scale
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)
