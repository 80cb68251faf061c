"""Plain PyTorch version of the paged chunk attention kernel.

The counterpart of ``paged_chunk_attention_ref`` in the JAX package: a
dense gather of every sequence's pages through the CoW indirection, the
optional int8 dequant, then one masked softmax over the cached positions
and the causal in-chunk block.  The wrapper in ``ops.py`` runs it for CPU
tensors; on the card it is what the CUDA kernel is held against.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def paged_chunk_attention_ref(
    q: torch.Tensor,             # [b, t, kv, g, hd]
    k_new: torch.Tensor,         # [b, t, kv, hd] chunk K, not in the pool
    v_new: torch.Tensor,
    k_pages: torch.Tensor,       # [n_pages, page, kv, hd] (int8 if quantized)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [b, max_pages] int32
    lengths: torch.Tensor,       # [b] int32 cached length (chunk excluded)
    page_map: Optional[torch.Tensor] = None,  # [n_pages] CoW dst -> src
    k_scales: Optional[torch.Tensor] = None,  # [n_pages, kv] f32
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns ``[b, t, kv, g, hd]`` in q's dtype."""
    b, t, kv, g, hd = q.shape
    page = k_pages.shape[1]
    s = block_tables.shape[1] * page
    tables = block_tables.long()
    if page_map is not None:
        tables = page_map.long()[tables]           # resolve CoW redirects
    k = k_pages[tables].float()                    # [b, mp, page, kv, hd]
    v = v_pages[tables].float()
    if k_scales is not None:
        k = k * k_scales[tables][:, :, None, :, None]
        v = v * v_scales[tables][:, :, None, :, None]
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)

    scale = 1.0 / math.sqrt(hd)
    qf = q.float()
    sc = torch.einsum("btkgh,bskh->btkgs", qf, k) * scale
    pos = torch.arange(s, device=q.device)
    cached = pos[None, :] < lengths.long()[:, None]              # [b, s]
    sc = sc.masked_fill(~cached[:, None, None, None, :], float("-inf"))
    sn = torch.einsum("btkgh,bjkh->btkgj", qf, k_new.float()) * scale
    tok = torch.arange(t, device=q.device)
    causal = tok[:, None] >= tok[None, :]                        # [t, j]
    sn = sn.masked_fill(~causal[None, :, None, None, :], float("-inf"))

    probs = torch.softmax(torch.cat([sc, sn], dim=-1), dim=-1)
    out = (torch.einsum("btkgs,bskh->btkgh", probs[..., :s], v)
           + torch.einsum("btkgj,bjkh->btkgh", probs[..., s:],
                          v_new.float()))
    return out.to(q.dtype)
