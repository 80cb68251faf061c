"""Causal GQA flash attention (forward): the wrapper the dense prefill calls.

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor launches
the hand-written kernel in ``csrc/flash_attention.cu`` or raises — there is
no fallback on the card.  bf16 runs the tensor-core design (wgmma, TMA), f32
the CUDA-core one.  Prompts of any length run (the kernel masks its
ragged tail).  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

NAME = "flash_attention"
LAUNCHES = {NAME: 0}
HEAD_DIMS = (32, 64, 112, 128, 160)
#: bf16 terms each f32 operand of the bf16 kernel's tensor-core products is
#: split into (P in O += P.V); tests/test_torch_tc_numerics.py chose them
SPLIT_TERMS = {"P": 2}


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q: [b, s, h, hd]; k, v: [b, s, kv, hd]; returns [b, s, h, hd]."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {q.device}")
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{NAME}: q must be float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS or h % kv:
        raise ValueError(f"{NAME}: head_dim {hd} not in {HEAD_DIMS} or "
                         f"{h} heads not a multiple of {kv} kv heads")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{NAME}: {name} is {x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
    if tuple(k.shape) != (b, s, kv, hd) or k.shape != v.shape:
        raise ValueError(f"{NAME}: k/v {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    _build.check_aligned(NAME, q=q, k=k, v=v)
    out = torch.empty_like(q)
    fn = _build.entry(NAME)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, kv, hd, int(q.dtype == torch.bfloat16),
            1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(NAME, rc)
    LAUNCHES[NAME] += 1
    return out
