"""Dense transformer layers of the port: norm, rotary, GQA projection, MLP,
the training attention block and one-token decode attention over a
contiguous KV cache.

Counterparts of ``repro/models/layers.py``.  Parameters keep the JAX
package's layout (``wq`` is ``[d, h, hd]``, ``wo`` is ``[h, hd, d]``, ...)
so weights cross between the packages unchanged; layer parameters are
stacked ``[L, ...]`` and :func:`layer_params` slices one layer out.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.blocked import is_blocked, unbind_layers
from repro_torch.kernels.flash_attention import flash_attention

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# initialization helpers
# ---------------------------------------------------------------------------

class MetaGenerator:
    """Stands in for a generator on the ``meta`` device (which has none):
    the init functions allocate their shapes there and draw nothing, the
    counterpart of ``jax.eval_shape`` over the JAX package's init."""
    device = torch.device("meta")


META = MetaGenerator()


def init_generator(generator: Optional[torch.Generator], device: Any
                   ) -> Any:
    """The generator an init draws from: ``generator``, or :data:`META`
    where none is given and ``device`` is ``meta`` (nothing is drawn)."""
    if generator is not None:
        return generator
    if device is not None and torch.device(device).type == "meta":
        return META
    raise ValueError("an init draws its weights from a seeded generator; "
                     "only device='meta' (shapes only) needs none")


def dense_init(gen: torch.Generator, shape: Tuple[int, ...],
               dtype: torch.dtype, fan_in: Optional[int] = None
               ) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights, drawn in float32 on ``gen``'s device
    (on ``meta``: the shape only)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    if fan_in is None:
        fan_in = shape[-2] if len(shape) > 1 else shape[-1]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(std).to(dtype)      # in place: one f32 draw at a time


def layer_params(p: Any, i: int) -> Any:
    """Layer ``i`` of a stacked ``[L, ...]`` parameter tree (views)."""
    if isinstance(p, dict):
        return {k: layer_params(v, i) for k, v in p.items()}
    return p[i]


def unstack_layers(p: Any, n: int) -> List[Any]:
    """The ``n`` layer trees of a stacked ``[L, ...]`` tree, each leaf
    split by one ``unbind``: its backward stacks the layers' gradients
    once, where ``n`` selects would each write a zero-filled ``[L, ...]``
    gradient.  A leaf stored as blocks over a mesh gives each layer's
    blocks as views (:func:`blocked.unbind_layers`), nothing gathered."""
    if isinstance(p, dict):
        parts = {k: unstack_layers(v, n) for k, v in p.items()}
        return [{k: parts[k][i] for k in p} for i in range(n)]
    if is_blocked(p):
        return unbind_layers(p, n)
    return list(torch.unbind(p[:n], 0))


def remat(fn: Callable, *args: Any) -> Any:
    """``fn(*args)`` with its activations recomputed in the backward
    instead of kept, as ``jax.checkpoint``.  It runs as is where nothing
    records a backward, and under a ``torch.func`` transform, which cannot
    run checkpoint's saved-tensor hooks (the transform keeps what it
    needs)."""
    if (not torch.is_grad_enabled()
            or torch._C._functorch.peek_interpreter_stack() is not None):
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(x.dtype)


def gated_rms_norm(x: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Mamba2's output norm: RMSNorm(x * silu(z)), in f32, rounded once."""
    xf = x.float() * F.silu(z.float())
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding (split-half rotation)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs       # [..., s, hd/2]
    cos = torch.cos(angles)[..., :, None, :]               # [..., s, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention projections and MLP
# ---------------------------------------------------------------------------

def init_attention(cfg: ArchConfig, gen: torch.Generator,
                   dtype: torch.dtype) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p: Params = {
        "wq": dense_init(gen, (d, h, hd), dtype, fan_in=d),
        "wk": dense_init(gen, (d, kv, hd), dtype, fan_in=d),
        "wv": dense_init(gen, (d, kv, hd), dtype, fan_in=d),
        "wo": dense_init(gen, (h, hd, d), dtype, fan_in=h * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=gen.device)
        p["bk"] = torch.zeros((kv, hd), dtype=dtype, device=gen.device)
        p["bv"] = torch.zeros((kv, hd), dtype=dtype, device=gen.device)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).unflatten(-1, (h, hd))


def qkv_project(cfg: ArchConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [b, s, d] -> q [b, s, h, hd], k/v [b, s, kv, hd] (rope applied)."""
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.contiguous()


def attn_out(a: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, hd, d = wo.shape
    return a.reshape(*a.shape[:-2], h * hd) @ wo.reshape(h * hd, d)


class _WideProduct(torch.autograd.Function):
    """``x @ w`` of 2-D bf16 (fp16) operands returned in f32: cuBLAS's f32
    output (``torch.mm(..., out_dtype=)``, which has no derivative of its
    own).  The backward is the narrow product's: the output's gradient,
    rounded to the operands' type, through two products."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w.T, x.T @ g


def partial_product(x: torch.Tensor, w: torch.Tensor,
                    shards: int) -> torch.Tensor:
    """``x @ w`` (``x`` ``[..., k]``, ``w`` ``[k, n]``) as one of ``shards``
    tensor-parallel partials, whose sum the caller rounds once to ``x``'s
    type: on the card, with more than one shard, bf16 (fp16) operands give
    the f32 accumulator itself, so the sum rounds once as one device's
    product does (and the all-reduce moves f32); one shard, f32 operands
    (the CPU) and shapes on ``meta`` give the product in ``x``'s type."""
    if not (shards > 1 and x.is_cuda
            and x.dtype in (torch.bfloat16, torch.float16)):
        return x @ w
    y = _WideProduct.apply(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _attn_chunk(s: int, chunk: int) -> int:
    """Query rows per chunk: ``chunk``, or ``gcd(chunk, s)`` where it does
    not divide ``s``, as the JAX package."""
    chunk = min(chunk, s)
    return chunk if s % chunk == 0 else math.gcd(chunk, s)


def _chunk_attention(q_c: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     c0: int) -> torch.Tensor:
    """Causal attention of the query rows ``[c0, c0 + c)`` over the keys
    ``k, v`` ``[b, c0 + c, kv, hd]`` (the later keys are masked for every
    row of the chunk, so they are left out).  Scores and softmax in f32,
    the probabilities in the value type for ``P·V``, as the JAX package."""
    b, c, h, hd = q_c.shape
    kvh = k.shape[2]
    qr = q_c.reshape(b, c, kvh, h // kvh, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qr.float(),
                          k.float()) * (1.0 / math.sqrt(hd))
    qpos = c0 + torch.arange(c, device=q_c.device)
    kpos = torch.arange(k.shape[1], device=q_c.device)
    mask = kpos[None, :] <= qpos[:, None]                    # [c, s]
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)
    return out.reshape(b, c, h, hd)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, chunk: int = 1024
                             ) -> torch.Tensor:
    """Causal GQA attention with O(s·chunk) score memory: q ``[b, s, h,
    hd]``, k/v ``[b, s, kv, hd]``.  Scores are computed one query chunk at
    a time and each chunk is recomputed in the backward (:func:`remat`),
    the flash-backward structure of the JAX package's version."""
    s = q.shape[1]
    chunk = _attn_chunk(s, chunk)
    return torch.cat([
        remat(_chunk_attention, q[:, c0:c0 + chunk], k[:, :c0 + chunk],
              v[:, :c0 + chunk], c0)
        for c0 in range(0, s, chunk)], dim=1)


#: f32 score elements one recomputed block of the backward may hold
VJP_SCORE_ELEMENTS = 1 << 27


def chunked_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          g: torch.Tensor, *, chunk: int = 1024
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The gradients of :func:`chunked_causal_attention` for ``q, k, v``
    given the output's gradient ``g``: each query chunk is recomputed and
    differentiated on its own (``torch.func.vjp``, which composes with the
    ``torch.func`` transforms), over as many batch rows at once as keep
    its scores within :data:`VJP_SCORE_ELEMENTS`.  The keys' gradients sum
    over the chunks from the last to the first in the keys' type, as
    autograd through :func:`chunked_causal_attention` (and the JAX
    package's scan transpose) sums them."""
    b, s, h, _ = q.shape
    chunk = _attn_chunk(s, chunk)
    rows = max(1, VJP_SCORE_ELEMENTS // (h * chunk * s))
    dq, dk, dv = [], [], []
    for b0 in range(0, b, rows):
        qb, kb, vb, gb = (x[b0:b0 + rows] for x in (q, k, v, g))
        dq_b, dk_b, dv_b = [], 0, 0
        for c0 in reversed(range(0, s, chunk)):
            end = c0 + chunk
            _, vjp = torch.func.vjp(
                lambda q_, k_, v_: _chunk_attention(q_, k_, v_, c0),
                qb[:, c0:end], kb[:, :end], vb[:, :end])
            dq_c, dk_c, dv_c = vjp(gb[:, c0:end])
            dq_b.insert(0, dq_c)
            pad = (0, 0, 0, 0, 0, s - end)
            dk_b = dk_b + F.pad(dk_c, pad)
            dv_b = dv_b + F.pad(dv_c, pad)
        dq.append(torch.cat(dq_b, dim=1))
        dk.append(dk_b)
        dv.append(dv_b)
    return torch.cat(dq), torch.cat(dk), torch.cat(dv)


def attention_block_kv(cfg: ArchConfig, p: Params, x: torch.Tensor,
                       positions: torch.Tensor, chunk: int = 1024,
                       attn: Optional[Callable] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention over the whole sequence: the projections, the flash
    attention kernel (its backward the chunked recompute, ``chunk`` query
    rows at a time; ``attn`` in its place where a caller binds the kernel
    itself), then ``wo``.  Returns (out, k, v)."""
    q, k, v = qkv_project(cfg, p, x, positions)
    a = (attn or flash_attention)(q, k, v, chunk)
    return attn_out(a, p["wo"]), k, v


def attention_block(cfg: ArchConfig, p: Params, x: torch.Tensor,
                    positions: torch.Tensor, chunk: int = 1024
                    ) -> torch.Tensor:
    """Training attention over the whole sequence (:func:`attention_block_kv`
    without the k and v)."""
    return attention_block_kv(cfg, p, x, positions, chunk)[0]


def decode_attention_dense(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, lengths: torch.Tensor
                           ) -> torch.Tensor:
    """One-token decode attention against a contiguous ``[b, S, kv, hd]``
    cache.  q: ``[b, 1, h, hd]``; lengths: ``[b]``, the valid cache
    positions (the token just written included).  Scores and softmax in
    f32, the probabilities rounded to the cache's type for the product with
    V, as the JAX package does."""
    b, _, h, hd = q.shape
    kvh = k_cache.shape[2]
    qr = q.reshape(b, kvh, h // kvh, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qr.float(),
                          k_cache.float()) * (1.0 / math.sqrt(hd))
    pos = torch.arange(k_cache.shape[1], device=q.device)
    mask = pos[None, :] < lengths[:, None]                  # [b, S]
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", probs.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, hd)


def attention_decode_block(cfg: ArchConfig, p: Params, x: torch.Tensor,
                           pos: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Decode: write this token's K/V at ``pos``, then attend.

    x: ``[b, 1, d]``.  ``pos`` is a scalar tensor (a position-aligned
    batch: one row written for every sequence) or ``[b]`` (per-sequence
    positions, scattered).  The row is written **into the cache it is
    given**, which is also returned: a copy of the whole cache per step
    would move ``L * b * max_len * kv * hd`` elements for every token.
    Returns (out ``[b, 1, d]``, k_cache, v_cache).
    """
    b = x.shape[0]
    if pos.dim() == 0:
        q, k, v = qkv_project(cfg, p, x, pos.reshape(1, 1))
        row = pos.reshape(1).long()
        k_cache.index_copy_(1, row, k)
        v_cache.index_copy_(1, row, v)
        lengths = (pos + 1).expand(b)
    else:
        q, k, v = qkv_project(cfg, p, x, pos[:, None])
        idx = (torch.arange(b, device=x.device), pos.long())
        k_cache.index_put_(idx, k[:, 0])
        v_cache.index_put_(idx, v[:, 0])
        lengths = pos + 1
    out = decode_attention_dense(q, k_cache, v_cache, lengths)
    return attn_out(out, p["wo"]), k_cache, v_cache


def init_mlp(cfg: ArchConfig, gen: torch.Generator,
             dtype: torch.dtype) -> Params:
    """MLP weights: ``wu``, ``wd``, and the gate ``wg`` for the gated
    activations (swiglu, geglu); sqrelu has no gate."""
    d, f = cfg.d_model, cfg.d_ff
    p = {"wu": dense_init(gen, (d, f), dtype),
         "wd": dense_init(gen, (f, d), dtype)}
    if cfg.mlp_activation in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, (d, f), dtype)
    return p


def mlp_block(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """swiglu: (silu(x wg) * (x wu)) wd; geglu: (gelu(x wg) * (x wu)) wd
    with gelu's tanh form (``jax.nn.gelu``'s default, not torch's); sqrelu:
    relu(x wu)^2 wd."""
    return mlp_hidden(cfg, p, x) @ p["wd"]


def mlp_hidden(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """:func:`mlp_block` up to ``wd``: the activated ``[..., d_ff]``."""
    act = cfg.mlp_activation
    up = x @ p["wu"]
    if act == "swiglu":
        return F.silu(x @ p["wg"]) * up
    if act == "geglu":
        return F.gelu(x @ p["wg"], approximate="tanh") * up
    if act == "sqrelu":
        return torch.square(F.relu(up))
    raise ValueError(f"unknown activation {act}")
