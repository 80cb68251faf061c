"""Paged attention: the two wrappers the serving engine calls.

* :func:`paged_chunk_attention` serves the fused decode step (t = 1),
  speculative verify (t = k) and the prefix-cache suffix prefill (t =
  suffix length).
* :func:`paged_attention` serves the legacy ``attn_impl="ref"`` decode
  step: cached-only attention, the token's K/V already in the pool.

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor launches
the hand-written kernel in ``csrc/paged_chunk_attention.cu`` (one page
walk, two entry points) or raises — there is no fallback on the card.
bf16 q (bf16 or int8 pools) runs the tensor-core walk: one launch per call,
its page ranges split over a thread-block cluster that merges them itself.
float32 runs the CUDA-core walk, whose split calls launch a second kernel
that merges the splits.  ``LAUNCHES`` counts each wrapper's kernel launches
apart.  On ``meta`` tensors each wrapper returns the output's shape and
type and reports its kernel's work (:func:`cost`, :func:`cached_cost`) to
the active op counter (:mod:`repro_torch.accounting`); a meta tensor holds
no lengths, so every table entry counts as walked.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import accounting
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref,
    paged_chunk_attention_ref,
)

NAME = "paged_chunk_attention"
CACHED_NAME = "paged_attention"
LAUNCHES = {NAME: 0, CACHED_NAME: 0}
HEAD_DIMS = (32, 64, 128, 160)
ROWS_PER_BLOCK = 8     # PCA_ROWS of the f32 kernel: query rows per block
#: the bf16 kernel's blocks: up to ONE_WARP_ROWS query rows (t * g) go to
#: one-warp blocks of 16 rows, more to four-warp blocks of 64 rows; and the
#: blocks per SM the split aims at for each (the fastest on an H100 at the
#: dense path's decode, verify and suffix-prefill shapes, PERF.md)
ONE_WARP_ROWS = 32
TC_ROWS = (16, 64)
TC_BLOCKS_PER_SM = (4, 2)
#: the most page ranges a call's walk is split into (bf16: the cluster
#: size; above 8 the kernel asks for non-portable clusters, which an H100
#: takes)
MAX_SPLITS = 16
#: bf16 terms each f32 operand of the bf16 kernel's tensor-core products is
#: split into (P in O += P.V); tests/test_torch_tc_numerics.py chose them
SPLIT_TERMS = {"P": 2}


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_count(b: int, t: int, kv: int, g: int, sms: int,
                tc: bool = True) -> int:
    """How many page ranges each row's walk is split into on a card with
    ``sms`` SMs.  bf16 (``tc``): about ``TC_BLOCKS_PER_SM`` blocks per SM,
    at most ``MAX_SPLITS``.  f32: 1 when the blocks already fill a wave,
    else about four blocks per SM."""
    rows = t * g
    if tc:
        i = 0 if rows <= ONE_WARP_ROWS else 1
        blocks = b * kv * -(-rows // TC_ROWS[i])
        return max(1, min(MAX_SPLITS, TC_BLOCKS_PER_SM[i] * sms // blocks))
    blocks = b * kv * -(-rows // ROWS_PER_BLOCK)
    if blocks >= sms:
        return 1
    return min(MAX_SPLITS, -(-4 * sms // blocks))


def n_splits(b: int, t: int, kv: int, g: int, device: torch.device,
             tc: bool = True) -> int:
    """:func:`split_count` for ``device``'s card."""
    return split_count(b, t, kv, g, _sm_count(device), tc)


def _check(q, k_new, v_new, k_pages, v_pages, block_tables, lengths,
           page_map, k_scales, v_scales) -> bool:
    """Validate a CUDA call; returns whether the pools are int8."""
    b, t, kv, g, hd = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{NAME}: q must be float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head_dim {hd} not in {HEAD_DIMS}")
    quant = k_pages.dtype == torch.int8
    pool_dtype = torch.int8 if quant else q.dtype
    expect = {
        "k_new": (k_new, (b, t, kv, hd), q.dtype),
        "v_new": (v_new, (b, t, kv, hd), q.dtype),
        "k_pages": (k_pages, (k_pages.shape[0], k_pages.shape[1], kv, hd),
                    pool_dtype),
        "v_pages": (v_pages, tuple(k_pages.shape), pool_dtype),
        "block_tables": (block_tables, (b, block_tables.shape[-1]),
                         torch.int32),
        "lengths": (lengths, (b,), torch.int32),
        "page_map": (page_map, (k_pages.shape[0],), torch.int32),
    }
    if quant:
        if k_scales is None or v_scales is None:
            raise ValueError(f"{NAME}: int8 pools need k_scales and v_scales")
        for name, x in (("k_scales", k_scales), ("v_scales", v_scales)):
            expect[name] = (x, (k_pages.shape[0], kv), torch.float32)
    _build.check_tensors(NAME, q.device,
                         {"q": (q, q.shape, q.dtype), **expect})
    return quant


def cost(q: torch.Tensor, k_pages: torch.Tensor, lengths: Sequence[int],
         quantized: bool = False) -> Tuple[int, int]:
    """(bytes, operations) of one :func:`paged_chunk_attention` call whose
    rows have the cached ``lengths``: the cached K/V of each row up to its
    length, the chunk, q, the output and the table entries it walks."""
    b, t, kv, g, hd = q.shape
    page = k_pages.shape[1]
    qe = q.element_size()
    pe = k_pages.element_size()
    lens = list(lengths)
    cached = sum(lens)
    pages = sum(-(-n // page) for n in lens)
    nbytes = (2 * b * t * kv * g * hd * qe          # q in, out
              + 2 * b * t * kv * hd * qe            # chunk K/V
              + 2 * cached * kv * hd * pe           # cached K/V
              + 2 * pages * 4 + 2 * b * 4)          # table, page_map, lengths
    if quantized:
        nbytes += 2 * pages * kv * 4
    keys = sum(t * n + t * (t + 1) // 2 for n in lens)   # per (row group)
    return nbytes, 4 * hd * kv * g * keys                # q.k and p.v


def cached_cost(q: torch.Tensor, k_pages: torch.Tensor,
                lengths: Sequence[int]) -> Tuple[int, int]:
    """(bytes, operations) of one :func:`paged_attention` call: each row's
    cached K/V up to its length, q, the output, the table entries it walks,
    the lengths."""
    b, kv, g, hd = q.shape
    page = k_pages.shape[1]
    lens = list(lengths)
    pages = sum(-(-n // page) for n in lens)
    nbytes = (2 * b * kv * g * hd * q.element_size()
              + 2 * sum(lens) * kv * hd * k_pages.element_size()
              + pages * 4 + b * 4)
    return nbytes, 4 * hd * kv * g * sum(lens)


def _table_lengths(block_tables: torch.Tensor, k_pages: torch.Tensor
                   ) -> list:
    """Every row's table walked to its end: the lengths a meta call
    counts."""
    return [block_tables.shape[-1] * k_pages.shape[1]] * block_tables.shape[0]


def _splits(splits: int, name: str) -> int:
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"{name}: {splits} splits, not in 1..{MAX_SPLITS}")
    return splits


def _partials(splits: int, tc: bool, rows: int, hd: int,
              device: torch.device):
    """Per-split softmax states (max, sum, accumulator) the f32 combine
    kernel merges; none for an unsplit walk or the bf16 kernel, whose
    cluster merges in shared memory."""
    if splits == 1 or tc:
        return None, None, None
    part_m = torch.empty(splits * rows, dtype=torch.float32, device=device)
    return (part_m, torch.empty_like(part_m),
            torch.empty(splits * rows * hd, dtype=torch.float32,
                        device=device))


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def paged_chunk_attention(
    q: torch.Tensor,             # [b, t, kv, g, hd]
    k_new: torch.Tensor,         # [b, t, kv, hd]
    v_new: torch.Tensor,
    k_pages: torch.Tensor,       # [n_pages, page, kv, hd] (int8 if quantized)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [b, max_pages] int32
    lengths: torch.Tensor,       # [b] int32 cached length (chunk excluded)
    page_map: torch.Tensor,      # [n_pages] int32 CoW dst -> src
    k_scales: Optional[torch.Tensor] = None,  # [n_pages, kv] f32 (int8)
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused CoW-aware chunk attention.  Returns ``[b, t, kv, g, hd]``.

    ``lengths[i] <= max_pages * page`` and every table entry below
    ``ceil(lengths[i] / page)`` is a valid page (the branch manager's
    tables are); entries past that are never read.
    """
    if q.device.type == "cpu":
        return paged_chunk_attention_ref(q, k_new, v_new, k_pages, v_pages,
                                         block_tables, lengths, page_map,
                                         k_scales, v_scales)
    if q.device.type == "meta":
        accounting.kernel(NAME, *cost(
            q, k_pages, _table_lengths(block_tables, k_pages),
            quantized=k_pages.dtype == torch.int8))
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {q.device}")
    quant = _check(q, k_new, v_new, k_pages, v_pages, block_tables, lengths,
                   page_map, k_scales, v_scales)
    _build.check_aligned(NAME, q=q, k_new=k_new, v_new=v_new,
                         k_pages=k_pages, v_pages=v_pages)
    b, t, kv, g, hd = q.shape
    out = torch.empty_like(q)
    tc = q.dtype == torch.bfloat16
    splits = _splits(n_splits(b, t, kv, g, q.device, tc), NAME)
    parts = _partials(splits, tc, b * t * kv * g, hd, q.device)
    _build.launch(NAME, q.device,
                  q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                  k_pages.data_ptr(), v_pages.data_ptr(),
                  block_tables.data_ptr(), lengths.data_ptr(),
                  page_map.data_ptr(),
                  k_scales.data_ptr() if quant else None,
                  v_scales.data_ptr() if quant else None, out.data_ptr(),
                  *(_ptr(x) for x in parts),
                  b, t, kv, g, hd, k_pages.shape[1], block_tables.shape[1],
                  splits, int(tc), int(quant), 1.0 / math.sqrt(hd),
                  torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES[NAME] += 2 if parts[0] is not None else 1
    return out


def _check_cached(q, k_pages, v_pages, block_tables, lengths) -> None:
    """Validate a CUDA call of the cached-only decode kernel."""
    b, kv, g, hd = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{CACHED_NAME}: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{CACHED_NAME}: head_dim {hd} not in {HEAD_DIMS}")
    expect = {
        "q": (q, tuple(q.shape), q.dtype),
        "k_pages": (k_pages, (k_pages.shape[0], k_pages.shape[1], kv, hd),
                    q.dtype),
        "v_pages": (v_pages, tuple(k_pages.shape), q.dtype),
        "block_tables": (block_tables, (b, block_tables.shape[-1]),
                         torch.int32),
        "lengths": (lengths, (b,), torch.int32),
    }
    _build.check_tensors(CACHED_NAME, q.device, expect)


def paged_attention(
    q: torch.Tensor,             # [b, kv, g, hd]
    k_pages: torch.Tensor,       # [n_pages, page, kv, hd] f32/bf16
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [b, max_pages] int32
    lengths: torch.Tensor,       # [b] int32, the decoded token included
) -> torch.Tensor:
    """Cached-only decode attention over paged KV.  Returns
    ``[b, kv, g, hd]``; a row of length 0 gives zeros.

    ``lengths[i] <= max_pages * page`` and every table entry below
    ``ceil(lengths[i] / page)`` is a valid page; entries past that are
    never read.
    """
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   lengths)
    if q.device.type == "meta":
        accounting.kernel(CACHED_NAME, *cached_cost(
            q, k_pages, _table_lengths(block_tables, k_pages)))
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"{CACHED_NAME}: no kernel for device {q.device}")
    _check_cached(q, k_pages, v_pages, block_tables, lengths)
    b, kv, g, hd = q.shape
    _build.check_aligned(CACHED_NAME, q=q, k_pages=k_pages, v_pages=v_pages)
    out = torch.empty_like(q)
    tc = q.dtype == torch.bfloat16
    splits = _splits(n_splits(b, 1, kv, g, q.device, tc), CACHED_NAME)
    parts = _partials(splits, tc, b * kv * g, hd, q.device)
    _build.launch(CACHED_NAME, q.device,
                  q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                  *(_ptr(x) for x in parts), b, kv, g, hd, k_pages.shape[1],
                  block_tables.shape[1], splits, int(tc), 1.0 / math.sqrt(hd),
                  torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES[CACHED_NAME] += 2 if parts[0] is not None else 1
    return out
