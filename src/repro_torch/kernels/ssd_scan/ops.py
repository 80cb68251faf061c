"""Mamba2 SSD chunked scan (forward): the wrapper the SSM prefill calls.

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor launches
the hand-written kernel in ``csrc/ssd_scan.cu`` or raises — there is no
fallback on the card.  bf16 runs the tensor-core design (wgmma, TMA), f32
the CUDA-core one.  Any length runs (the kernel pads its ragged tail).
The kernel walks the sequence in its own row tile, so ``chunk`` shapes
only the plain version; the result does not depend on it in exact
arithmetic.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

NAME = "ssd_scan"
LAUNCHES = {NAME: 0}
STATE_DIMS = (64, 128)     # N: zamba2, mamba2
HEAD_DIMS = (64, 128)      # P
#: bf16 terms each f32 operand of the bf16 kernel's tensor-core products is
#: split into: W in y = W.x, S in y += exp(cum) C.S, wx in the state update
#: B^T (w o x); tests/test_torch_tc_numerics.py chose them
SPLIT_TERMS = {"W": 2, "S": 2, "wx": 2}


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


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b,s,H,P]; dt [b,s,H] f32 (post-softplus); A [H] f32 (negative);
    B/C [b,s,N].  Returns (y [b,s,H,P] in x's dtype, final state
    [b,H,N,P] f32)."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {x.device}")
    _check(x, dt, A, B, C)
    b, s, H, P = x.shape
    N = B.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((b, H, N, P), dtype=torch.float32, device=x.device)
    fn = _build.entry(NAME)
    rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr(), b, s, H, P, N,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(NAME, rc)
    LAUNCHES[NAME] += 1
    return y, state
