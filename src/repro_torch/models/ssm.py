"""Mamba2 (SSD) blocks of the port: the block over a sequence (training
and prefill), conv, one-token state update, init.

Counterparts of ``repro/models/ssm.py``.  The block's scan is the SSD scan
kernel (:func:`repro_torch.kernels.ssd_scan.ssd_scan`, with a recompute
backward); ``ssd_chunked`` is the port's one plain chunked scan,
:func:`repro_torch.kernels.ssd_scan.ref.ssd_scan_ref`, with its optional
initial state.

Layouts are the JAX package's:

  x:   [b, s, H, P]   (H = heads = d_inner / P, P = head dim)
  dt:  [b, s, H]      (post-softplus, f32)
  A:   [H]            (negative, f32)
  B,C: [b, s, N]      (one group, shared by every head)
  state: [b, H, N, P] f32

Every function here allocates its outputs and never writes into a tensor
it was given.  The recurrent state is branched by reference through
:class:`repro_torch.core.store.BranchStore`, so a parent and its children
share one tensor until one of them decodes: an in-place update would
change the state of every branch that shares it.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref as ssd_chunked
from repro_torch.models.layers import dense_init, gated_rms_norm

Params = Dict[str, Any]


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD update.  x [b,H,P], dt [b,H], B/C [b,N],
    state [b,H,N,P] f32 -> (y [b,H,P] in x's dtype, new state)."""
    dt = dt.float()
    dA = torch.exp(dt * A.float())                          # [b, H]
    upd = torch.einsum("bh,bn,bhp->bhnp", dt, B.float(), x.float())
    state = state * dA[:, :, None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", C.float(), state)
    return y.to(x.dtype), state


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """x [b, s, c]; w [c, ck]; depthwise causal conv + SiLU, in f32,
    rounded once to x's dtype."""
    ck = w.shape[1]
    s = x.shape[1]
    xp = F.pad(x.float(), (0, 0, ck - 1, 0))
    wf = w.float()
    y = xp[:, 0:s] * wf[:, 0]
    for i in range(1, ck):
        y = y + xp[:, i:i + s] * wf[:, i]
    return F.silu(y + b.float()).to(x.dtype)


def conv1d_decode(x: torch.Tensor, conv_state: torch.Tensor,
                  w: torch.Tensor, b: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b, c] new element; conv_state [b, ck-1, c] (pre-activation
    inputs).  Returns (y [b, c], new conv_state)."""
    window = torch.cat([conv_state, x[:, None, :]], dim=1)   # [b, ck, c]
    y = torch.einsum("bkc,ck->bc", window.float(), w.float())
    return F.silu(y + b.float()).to(x.dtype), window[:, 1:, :]


def init_mamba(cfg: ArchConfig, gen: torch.Generator,
               dtype: torch.dtype) -> Params:
    """Random Mamba2 block weights drawn from ``gen`` on its device;
    ``A_log``, ``D`` and ``dt_bias`` are f32, as in the JAX package."""
    d = cfg.d_model
    di, N, H = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    cdim, ck = cfg.ssm_conv_dim, cfg.ssm_conv_kernel
    dip = 2 * di + 2 * cfg.ssm_groups * N + H
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(gen, (d, dip), dtype, fan_in=d),
        "conv_w": dense_init(gen, (cdim, ck), dtype, fan_in=ck),
        "conv_b": torch.zeros((cdim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.log(torch.expm1(
            torch.logspace(-3, -1, H, **f32))),
        "norm_w": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (di, d), dtype, fan_in=di),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    di, cdim = cfg.ssm_d_inner, cfg.ssm_conv_dim
    return (zxbcdt[..., :di], zxbcdt[..., di:di + cdim],
            zxbcdt[..., di + cdim:])


def _split_xbc(cfg: ArchConfig, xBC: torch.Tensor):
    di, N = cfg.ssm_d_inner, cfg.ssm_state
    return xBC[..., :di], xBC[..., di:di + N], xBC[..., di + N:]


def softplus_dt(dt: torch.Tensor, dt_bias: torch.Tensor) -> torch.Tensor:
    """Post-softplus f32 step sizes (``jax.nn.softplus`` is exact here:
    torch's linear branch starts at 20, where log1p(e^x) = x in f32)."""
    return F.softplus(dt.float() + dt_bias)


def mamba_scan(cfg: ArchConfig, p: Params, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """The Mamba2 block up to its output norm, over the heads ``p`` holds
    (all of them, or one tp rank's: ``p["A_log"]`` has one entry per head;
    ``in_proj``'s columns are z, x, B, C and dt of those heads, B and C
    whole): (y ``[b, s, heads · P]`` before the norm, z, the conv state —
    the last ``ck - 1`` *pre-activation* conv inputs — and the final SSM
    state), the scan the SSD scan kernel."""
    b, s, _ = x.shape
    N, Pd = cfg.ssm_state, cfg.ssm_head_dim
    H = p["A_log"].shape[0]
    di = H * Pd
    zxbcdt = x @ p["in_proj"]
    cdim = di + 2 * cfg.ssm_groups * N
    z, xBC_pre, dt = (zxbcdt[..., :di], zxbcdt[..., di:di + cdim],
                      zxbcdt[..., di + cdim:])
    conv_state = xBC_pre[:, s - (cfg.ssm_conv_kernel - 1):, :]
    xBC = causal_conv1d(xBC_pre, p["conv_w"], p["conv_b"])
    xs, B, C = xBC[..., :di], xBC[..., di:di + N], xBC[..., di + N:]
    xs = xs.reshape(b, s, H, Pd).contiguous()
    A = -torch.exp(p["A_log"])
    y, ssm_state = ssd_scan(xs, softplus_dt(dt, p["dt_bias"]).contiguous(),
                            A, B.contiguous(), C.contiguous(), cfg.ssm_chunk)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xs
    return y.reshape(b, s, di), z, conv_state, ssm_state


def mamba_forward(cfg: ArchConfig, p: Params, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Mamba2 block over a sequence x ``[b, s, d]``, its scan the SSD
    scan kernel.  Returns (y ``[b, s, d]``, the conv state and the final
    SSM state; :func:`mamba_scan`)."""
    y, z, conv_state, ssm_state = mamba_scan(cfg, p, x)
    y = gated_rms_norm(y, z, p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], conv_state, ssm_state


def mamba_block(cfg: ArchConfig, p: Params, x: torch.Tensor
                ) -> torch.Tensor:
    """Training Mamba2 block: x ``[b, s, d]`` -> ``[b, s, d]`` (the states
    dropped)."""
    return mamba_forward(cfg, p, x)[0]


def mamba_decode_block(cfg: ArchConfig, p: Params, x: torch.Tensor,
                       conv_state: torch.Tensor, ssm_state: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token Mamba2 step.  x [b, 1, d]; conv_state [b, ck-1, conv_dim];
    ssm_state [b, H, N, P].  Returns (y [b, 1, d], conv, ssm), all new."""
    b = x.shape[0]
    di, H, Pd = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC, dt = _split_proj(cfg, x[:, 0] @ p["in_proj"])
    xBC, conv_state = conv1d_decode(xBC, conv_state, p["conv_w"],
                                    p["conv_b"])
    xs, B, C = _split_xbc(cfg, xBC)
    xs = xs.reshape(b, H, Pd)
    A = -torch.exp(p["A_log"])
    y, ssm_state = ssd_decode_step(xs, softplus_dt(dt, p["dt_bias"]), A, B,
                                   C, ssm_state)
    y = y + p["D"].to(y.dtype)[None, :, None] * xs
    y = gated_rms_norm(y.reshape(b, di), z, p["norm_w"], cfg.norm_eps)
    return (y @ p["out_proj"])[:, None, :], conv_state, ssm_state

