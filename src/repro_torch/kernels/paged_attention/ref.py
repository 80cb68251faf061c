"""Plain PyTorch versions of the two paged attention kernels.

* :func:`paged_chunk_attention_ref`, the counterpart of the JAX package's
  ``paged_chunk_attention_ref``: a dense gather of every sequence's pages
  through the CoW indirection, the optional int8 dequant, then one masked
  softmax over the cached positions and the causal in-chunk block.
* :func:`paged_attention_ref`, the counterpart of ``paged_attention_ref``:
  cached-only decode attention, the token's K/V already in the pool.

Both compute in f32 and round once.  The wrappers in ``ops.py`` run them
for CPU tensors; on the card they are what the CUDA kernels are held
against.
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


def paged_attention_ref(
    q: torch.Tensor,             # [b, kv, g, hd]
    k_pages: torch.Tensor,       # [n_pages, page, kv, hd]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [b, max_pages] int32 (padding: any page)
    lengths: torch.Tensor,       # [b] int32, the decoded token included
) -> torch.Tensor:
    """Returns ``[b, kv, g, hd]`` in q's dtype; a row of length 0 is 0
    (the TPU kernel's clamped softmax sum gives the same)."""
    b, kv, g, hd = q.shape
    page = k_pages.shape[1]
    s = block_tables.shape[1] * page
    tables = block_tables.long()
    k = k_pages[tables].float().reshape(b, s, kv, hd)
    v = v_pages[tables].float().reshape(b, s, kv, hd)
    sc = torch.einsum("bkgh,bskh->bkgs", q.float(), k) * (1.0 / math.sqrt(hd))
    pos = torch.arange(s, device=q.device)
    cached = (pos[None, :] < lengths.long()[:, None])[:, None, None, :]
    probs = torch.softmax(sc.masked_fill(~cached, float("-inf")), dim=-1)
    probs = probs.masked_fill(~cached, 0.0)      # length 0: 0, not NaN
    return torch.einsum("bkgs,bskh->bkgh", probs, v).to(q.dtype)
