"""Mamba2 SSD chunked scan: the wrapper the SSM prefill and the training
forward call, with a gradient.

The forward on a CPU tensor runs the plain version in ``ref.py``; on a
CUDA tensor it launches the hand-written kernel in ``csrc/ssd_scan.cu`` or
raises — there is no fallback on the card.  bf16 runs the tensor-core
design (wgmma, TMA), f32 the CUDA-core one.  Any length runs (the kernel
pads its ragged tail).  The kernel walks the sequence in its own row tile,
so ``chunk`` shapes only the plain version; the result does not depend on
it in exact arithmetic.  ``LAUNCHES`` counts kernel launches.  On ``meta``
tensors the wrapper returns the outputs' shapes and types and reports the
kernel's work (:func:`cost`) to the active op counter
(:mod:`repro_torch.accounting`); the backward's recompute runs on
``meta`` as on any device.

:class:`SSDScan` carries the gradient: the JAX package's SSD scan has no
VJP of its own (training differentiates its jnp ``ssd_chunked``), so the
backward recomputes the plain ``ssd_scan_ref`` and takes its VJP, on
either device; there is no backward kernel.  ``final_state``'s incoming
gradient may be absent (training drops the state).  Its ``vmap`` rule
folds the mapped dimension into the batch when ``A`` is not mapped (one
launch), and launches once per mapped slice when it is.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import accounting
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

NAME = "ssd_scan"
LAUNCHES = {NAME: 0}
STATE_DIMS = (64, 128)     # N: zamba2, mamba2
HEAD_DIMS = (64, 128)      # P
#: bf16 terms each f32 operand of the bf16 kernel's tensor-core products is
#: split into: W in y = W.x, S in y += exp(cum) C.S, wx in the state update
#: B^T (w o x); tests/test_torch_tc_numerics.py chose them (wx's third term
#: keeps the state f32-grade at any magnitude: tools/k4_state_error.py)
SPLIT_TERMS = {"W": 2, "S": 2, "wx": 3}
#: the bf16 kernel's row tile Q (the chunk its products are formed over)
ROWS = 64


def cost(x: torch.Tensor, B: torch.Tensor) -> Tuple[int, int]:
    """(bytes, operations) of one call: x, B, C, dt and A read once, y and
    the f32 state written once; the products of the chunked form at the
    kernel's row tile :data:`ROWS` (C.B over the causal half of each chunk
    once for all heads, then per head G.x, C.S and the state update)."""
    b, s, H, P = x.shape
    N = B.shape[-1]
    el = x.element_size()
    nbytes = (2 * x.numel() * el + 2 * B.numel() * el + b * s * H * 4
              + H * 4 + b * H * N * P * 4)
    tri = s * (ROWS + 1) // 2          # causal (q, k) pairs per row tile
    macs = b * (tri * N + H * (tri * P + 2 * s * N * P))
    return nbytes, 2 * macs


def _check(x, dt, A, B, C) -> None:
    b, s, H, P = x.shape
    N = B.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{NAME}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if N not in STATE_DIMS or P not in HEAD_DIMS:
        raise ValueError(f"{NAME}: state dim {N} not in {STATE_DIMS} or "
                         f"head dim {P} not in {HEAD_DIMS}")
    if s < 1:
        raise ValueError(f"{NAME}: empty sequence")
    expect = {"x": (x, (b, s, H, P), x.dtype),
              "dt": (dt, (b, s, H), torch.float32),
              "A": (A, (H,), torch.float32),
              "B": (B, (b, s, N), x.dtype),
              "C": (C, (b, s, N), x.dtype)}
    _build.check_tensors(NAME, x.device, expect)
    _build.check_aligned(NAME, x=x, B=B, C=C)


def _forward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version for CPU tensors, the kernel for CUDA tensors, the
    outputs' shapes on ``meta``."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C, chunk)
    if x.device.type == "meta":
        accounting.kernel(NAME, *cost(x, B))
        b, s, H, P = x.shape
        return (torch.empty_like(x),
                torch.empty((b, H, B.shape[-1], P), dtype=torch.float32,
                            device=x.device))
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {x.device}")
    _check(x, dt, A, B, C)
    b, s, H, P = x.shape
    N = B.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((b, H, N, P), dtype=torch.float32, device=x.device)
    _build.launch(NAME, x.device,
                  x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                  C.data_ptr(), y.data_ptr(), state.data_ptr(), b, s, H, P, N,
                  int(x.dtype == torch.bfloat16),
                  torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES[NAME] += 1
    return y, state


def ssd_scan_vjp(x, dt, A, B, C, gy: Optional[torch.Tensor],
                 gstate: Optional[torch.Tensor], chunk: int = 128
                 ) -> Tuple[torch.Tensor, ...]:
    """The gradients for ``x, dt, A, B, C`` given those of ``y`` and the
    final state (either may be ``None``: zero), through ``ssd_scan_ref``
    recomputed (``torch.func.vjp``, which composes with the ``torch.func``
    transforms)."""
    (y, state), vjp = torch.func.vjp(
        lambda *a: ssd_scan_ref(*a, chunk=chunk), x, dt, A, B, C)
    return vjp((torch.zeros_like(y) if gy is None else gy,
                torch.zeros_like(state) if gstate is None else gstate))


class SSDScan(torch.autograd.Function):
    """The scan with a recompute backward through ``ssd_scan_ref``."""

    @staticmethod
    def forward(x, dt, A, B, C, chunk: int):
        return _forward(x, dt, A, B, C, chunk)

    @staticmethod
    def setup_context(ctx: Any, inputs: Tuple, output: Tuple) -> None:
        *tensors, chunk = inputs
        ctx.save_for_backward(*tensors)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx: Any, gy: torch.Tensor, gstate: torch.Tensor):
        with torch.profiler.record_function("ssd_scan.backward"):
            return (*ssd_scan_vjp(*ctx.saved_tensors, gy, gstate,
                                  chunk=ctx.chunk), None)

    @staticmethod
    def vmap(info: Any, in_dims: Tuple, x, dt, A, B, C, chunk: int):
        n = info.batch_size
        args = [t.movedim(d, 0) if d is not None
                else t.unsqueeze(0).expand(n, *t.shape)
                for t, d in zip((x, dt, A, B, C), in_dims)]
        if in_dims[2] is None:
            # A is shared: fold the mapped dimension into the batch
            x, dt, _, B, C = (t.reshape(-1, *t.shape[2:]).contiguous()
                              for t in args)
            y, state = SSDScan.apply(x, dt, A, B, C, chunk)
            return (y.unflatten(0, (n, -1)), state.unflatten(0, (n, -1))), \
                (0, 0)
        outs = [SSDScan.apply(*(t[i].contiguous() for t in args), chunk)
                for i in range(n)]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs])), (0, 0)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b,s,H,P]; dt [b,s,H] f32 (post-softplus); A [H] f32 (negative);
    B/C [b,s,N].  Returns (y [b,s,H,P] in x's dtype, final state
    [b,H,N,P] f32), differentiable in ``x, dt, A, B, C``."""
    return SSDScan.apply(x, dt, A, B, C, chunk)
