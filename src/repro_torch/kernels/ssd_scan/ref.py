"""Plain PyTorch version of the SSD scan kernel.

The chunked dual form of ``ssd_chunked`` in ``repro/models/ssm.py``, with
two differences that are exact in real arithmetic:

* a length that is not a multiple of ``chunk`` pads its ragged tail with
  ``dt = 0`` and ``x = 0`` (decay ``exp(0) = 1``, added term 0), where the
  JAX function falls back to a chunk of ``gcd(chunk, s)``;
* everything is computed in f32 from the inputs as given and ``y`` is
  rounded once, where the JAX function casts ``W``, ``wk``, the in-chunk
  decay and the carried state to ``x``'s dtype on the way.

The decays are formed from segment sums: ``exp(sum_{k<i<=q} dt_i A)``
directly, not as ``exp(cum_q - cum_k)``.  The difference of two running
sums loses ``|cum| * 2**-24`` to cancellation, and at the model's step
sizes ``|cum|`` over a chunk reaches the hundreds, so ``y`` would carry a
relative error of ~1e-5 from that alone; a segment sum of same-signed
terms keeps its rounding relative to itself, and the exponential damps it.
The segment sums exist only on and below the diagonal (above it the
exponent would be positive and could overflow).  The wrapper in ``ops.py``
runs this for CPU tensors; on the card it is what the CUDA kernel is held
against, and ``repro_torch.models.ssm`` exports it as the port's
``ssd_chunked``, which takes the same optional ``initial_state``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int = 128,
                 initial_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b,s,H,P]; dt [b,s,H] (post-softplus); A [H]; B/C [b,s,N];
    initial_state [b,H,N,P] (zero if ``None``).

    Returns (y [b,s,H,P] in x's dtype, final state [b,H,N,P] f32).
    """
    b, s, H, P = x.shape
    N = B.shape[-1]
    Q = max(1, min(chunk, s))
    nc = -(-s // Q)
    pad = nc * Q - s

    def chunks(t: torch.Tensor) -> torch.Tensor:
        """[b, s, ...] -> [b, nc, Q, ...] in f32, the tail zero-padded."""
        t = t.float()
        if pad:
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(b, nc, Q, *t.shape[2:])

    xr, dtr, Br, Cr = chunks(x), chunks(dt), chunks(B), chunks(C)
    dA = dtr * A.float()                                    # [b,nc,Q,H]
    cum = torch.cumsum(dA, dim=2)

    # segment sums seg[q, k] = sum_{k<i<=q} dA_i, on and below the diagonal
    ones = torch.ones(Q, Q, dtype=torch.bool, device=x.device)
    below = ones.tril(-1)[None, None, :, :, None]
    seg = torch.cumsum(dA[:, :, :, None, :].expand(-1, -1, -1, Q, -1)
                       .masked_fill(~below, 0.0), dim=2)    # [b,nc,q,k,H]
    causal = ones.tril()[None, None, :, :, None]

    # intra-chunk dual form
    cb = torch.einsum("bcqn,bckn->bcqk", Cr, Br)
    decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
    W = cb[..., None] * decay * dtr[:, :, None, :, :]
    y = torch.einsum("bcqkh,bckhp->bcqhp", W, xr)

    # chunk boundary states and the carried recurrence
    wk = dtr * torch.exp(seg[:, :, -1])                     # [b,nc,Q,H]
    S = torch.einsum("bckh,bckn,bckhp->bchnp", wk, Br, xr)  # [b,nc,H,N,P]
    chunk_decay = torch.exp(cum[:, :, -1, :])               # [b,nc,H]
    in_decay = torch.exp(cum)                               # [b,nc,Q,H]
    h = (torch.zeros((b, H, N, P), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    y_off = []
    for c in range(nc):
        y_off.append(torch.einsum("bqn,bhnp->bqhp", Cr[:, c], h)
                     * in_decay[:, c, :, :, None])
        h = chunk_decay[:, c, :, None, None] * h + S[:, c]
    y = y + torch.stack(y_off, dim=1)
    return y.reshape(b, nc * Q, H, P)[:, :s].to(x.dtype), h
