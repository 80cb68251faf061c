"""Causal GQA flash attention: the wrapper the dense prefill and the
training forward call, with a gradient.

The forward on a CPU tensor runs the plain version in ``ref.py``; on a
CUDA tensor it launches the hand-written kernel in
``csrc/flash_attention.cu`` or raises — there is no fallback on the card.
bf16 runs the tensor-core design (wgmma, TMA), f32 the CUDA-core one.
Prompts of any length run (the kernel masks its ragged tail).
``LAUNCHES`` counts kernel launches.  On ``meta`` tensors (the dry run's
shape-only pass) the wrapper computes nothing: it returns the output's
shape and type and reports the kernel's work (:func:`cost`) to the active
op counter (:mod:`repro_torch.accounting`); the backward's plain recompute
runs on ``meta`` as on any device, and the counter sees its ops.

:class:`FlashAttention` carries the gradient, as the JAX package's
``custom_vjp`` does (``repro/kernels/flash_attention/ops.py``): the
forward saves ``q, k, v`` and the backward recomputes the attention
through the plain chunked version one query chunk at a time
(:func:`repro_torch.models.layers.chunked_attention_vjp`), on either
device; there is no backward kernel.  Its ``vmap`` rule folds the mapped
dimension into the batch, so ``torch.func.vmap`` (which cannot see through
a raw-pointer launch) still launches the kernel once.
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from repro_torch import accounting
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

NAME = "flash_attention"
LAUNCHES = {NAME: 0}
HEAD_DIMS = (32, 64, 112, 128, 160)
#: bf16 terms each f32 operand of the bf16 kernel's tensor-core products is
#: split into (P in O += P.V); tests/test_torch_tc_numerics.py chose them
SPLIT_TERMS = {"P": 2}


def cost(q: torch.Tensor, k: torch.Tensor) -> Tuple[int, int]:
    """(bytes, operations) of one call: q, k, v read once and the output
    written once; q.k and p.v over the causal half (the kernel skips the
    tiles above the diagonal)."""
    b, s, h, hd = q.shape
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return nbytes, 4 * hd * h * b * s * (s + 1) // 2


def _forward(q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """The plain version for CPU tensors, the kernel for CUDA tensors, the
    output's shape on ``meta``."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    if q.device.type == "meta":
        accounting.kernel(NAME, *cost(q, k))
        return torch.empty_like(q)
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
    _build.launch(NAME, q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, s, h, kv, hd, int(q.dtype == torch.bfloat16),
                  1.0 / math.sqrt(hd),
                  torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES[NAME] += 1
    return out


class FlashAttention(torch.autograd.Function):
    """The attention with a recompute backward (``chunk``: the query rows
    per recomputed block of the backward)."""

    @staticmethod
    def forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                chunk: int) -> torch.Tensor:
        return _forward(q, k, v)

    @staticmethod
    def setup_context(ctx: Any, inputs: Tuple, output: torch.Tensor) -> None:
        q, k, v, chunk = inputs
        ctx.save_for_backward(q, k, v)
        ctx.chunk = chunk

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor):
        # models.layers imports this module: import it at use
        from repro_torch.models.layers import chunked_attention_vjp

        q, k, v = ctx.saved_tensors
        with torch.profiler.record_function("flash_attention.backward"):
            return (*chunked_attention_vjp(q, k, v, g, chunk=ctx.chunk),
                    None)

    @staticmethod
    def vmap(info: Any, in_dims: Tuple, q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, chunk: int):
        n = info.batch_size

        def fold(x: torch.Tensor, dim) -> torch.Tensor:
            x = (x.unsqueeze(0).expand(n, *x.shape) if dim is None
                 else x.movedim(dim, 0))
            return x.reshape(n * x.shape[1], *x.shape[2:]).contiguous()

        out = FlashAttention.apply(fold(q, in_dims[0]), fold(k, in_dims[1]),
                                   fold(v, in_dims[2]), chunk)
        return out.unflatten(0, (n, -1)), 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    chunk: int = 1024) -> torch.Tensor:
    """q: [b, s, h, hd]; k, v: [b, s, kv, hd]; returns [b, s, h, hd].
    Differentiable in ``q, k, v``; ``chunk`` shapes only the backward."""
    return FlashAttention.apply(q, k, v, chunk)
