"""The shard-local passes of a layer over tensor-parallel shards, shared by
the serving engine (``runtime/serve_loop.py``) and the training forward
over a mesh (``models/transformer.py``).

One host process drives every shard: a shard is a parameter tree on its
device (its heads, kv heads, d_ff slice or experts; replicated leaves
whole), and a list holds one entry per shard in shard order.  The
residual stream lives on shard 0's device; each sublayer's normed input
is copied to every shard (:func:`~repro_torch.distributed.collectives.
broadcast`), each shard computes its partial, and the partials are summed
on shard 0 in shard order (:func:`~repro_torch.distributed.collectives.
psum`).  On the card, with more than one shard, a bf16 partial stays in
f32 (the product's accumulator: :func:`layers.partial_product`; the sum
moves f32) and the sum is rounded once, as one device's product is, so
the shards' sum differs from one device's by the f32 summation order
only.  Every op is an ordinary differentiable tensor op, so autograd runs
the backward through the copies and sums: a leaf replicated over the
shards (norms, the router) gets the sum of its shards' gradients, and a
sliced leaf the gradients of its slices.  The counterpart of the JAX
package's ``shard_map`` bodies and of XLA's partitioning of
``Model.loss``.

The Mamba2 block (:func:`mamba`) splits over its SSD heads: each rank
projects, convolves and scans its heads (B and C, one group, on every
rank), the gated output norm sums its f32 squares over the ranks
(:func:`gated_rms_norm`), and ``out_proj``'s partials are summed as the
FFN's are.  The hybrid's shared block (:func:`shared_block`) is the
attention and MLP passes after ``w_concat``, on rank 0.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.collectives import all_gather, broadcast, psum
from repro_torch.models import layers as L
from repro_torch.models.moe import moe_apply_sharded
from repro_torch.models.ssm import mamba_scan

Params = Dict[str, Any]

#: the mesh axis the shard-local passes' sums and gathers span in a
#: training plan (the op counter's accounting; a serving mesh's ``tp`` axis
#: plays its part)
AXES = ("model",)


def shard_device(tree: Params) -> torch.device:
    """The device a shard's parameter tree lies on."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.device


def attention(cfg: ArchConfig, lps: Sequence[Params],
              xs: Sequence[torch.Tensor], positions: Sequence[torch.Tensor],
              chunk: int = 1024, attn: Optional[Callable] = None
              ) -> Tuple[torch.Tensor, List[torch.Tensor],
                         List[torch.Tensor]]:
    """Causal attention over the whole sequence, each shard's heads on its
    device (the flash attention kernel at the shard's head counts, or the
    caller's ``attn``): (the output summed on shard 0, each shard's k and
    v).  Shards holding every head (:func:`replicated`) each compute the
    whole block, and shard 0's output is added once."""
    parts, ks, vs = [], [], []
    for lp, x, pos in zip(lps, xs, positions):
        q, k, v = L.qkv_project(cfg, lp, x, pos)
        a = (attn or L.flash_attention)(q, k, v, chunk)
        parts.append(head_partial(a, lp["wo"], len(lps)))
        ks.append(k)
        vs.append(v)
    return combine_heads(cfg, lps, parts), ks, vs


def head_partial(a: torch.Tensor, wo: torch.Tensor,
                 shards: int) -> torch.Tensor:
    """A shard's heads ``a`` ``[..., h, hd]`` through its ``wo`` rows: its
    partial of the attention output, one of ``shards``
    (:func:`layers.partial_product`: f32 on the card at more than one,
    rounded once after the sum by :func:`combine_heads`)."""
    h, hd, d = wo.shape
    return L.partial_product(a.reshape(*a.shape[:-2], h * hd),
                             wo.reshape(h * hd, d), shards)


def replicated(cfg: ArchConfig, lps: Sequence[Params]) -> bool:
    """Whether the shards' attention trees ``lps`` each hold every query
    head (the heads do not split over them: ``sharding.heads_split``)."""
    return len(lps) > 1 and lps[0]["wq"].shape[1] == cfg.num_heads


def combine_heads(cfg: ArchConfig, lps: Sequence[Params],
                  parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The attention block's output from its shards' partials
    (:func:`head_partial`): their sum on shard 0, or shard 0's own where
    every shard computed the whole block (:func:`replicated`), rounded once
    to the weights' type."""
    out = parts[0] if replicated(cfg, lps) else psum(parts, AXES)
    return out.to(lps[0]["wo"].dtype)


def ffn(cfg: ArchConfig, lps: Sequence[Params], xs: Sequence[torch.Tensor]
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The post-attention FFN of one layer on each shard's copy of the
    ln2-normed input: each shard's d_ff slice of the MLP summed over shards,
    or its experts of the MoE block (every row of the call routed
    together; the combine in f32, rounded once).  Returns (y on shard 0,
    the MoE aux loss or 0)."""
    x0 = xs[0]
    if cfg.is_moe:
        d = cfg.d_model
        y, aux = moe_apply_sharded(cfg, [lp["moe"] for lp in lps],
                                   [x.reshape(-1, d) for x in xs])
        return y.reshape(x0.shape), aux
    parts = [L.partial_product(L.mlp_hidden(cfg, lp["mlp"], x),
                               lp["mlp"]["wd"], len(lps))
             for lp, x in zip(lps, xs)]
    return (psum(parts, AXES).to(x0.dtype),
            x0.new_zeros((), dtype=torch.float32))


def layer(cfg: ArchConfig, lps: Sequence[Params], h: torch.Tensor,
          positions: Sequence[torch.Tensor], chunk: int = 1024
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm attention + FFN layer over the shards' layer trees
    ``lps``, the residual ``h`` on shard 0's device: (h, aux)."""
    devices = [shard_device(lp) for lp in lps]
    x = L.rms_norm(h, lps[0]["ln1"], cfg.norm_eps)
    a, _, _ = attention(cfg, [lp["attn"] for lp in lps],
                        broadcast(x, devices), positions, chunk)
    h = h + a
    x = L.rms_norm(h, lps[0]["ln2"], cfg.norm_eps)
    y, aux = ffn(cfg, lps, broadcast(x, devices))
    return h + y, aux


def gated_rms_norm(ys: Sequence[torch.Tensor], zs: Sequence[torch.Tensor],
                   ws: Sequence[torch.Tensor], eps: float, n: int
                   ) -> List[torch.Tensor]:
    """Mamba2's output norm (:func:`layers.gated_rms_norm`) of a row split
    over the ranks, each rank's slice ``ys[r]``, ``zs[r]`` and weight
    ``ws[r]`` on its device: each rank's f32 sum of the squares of its
    slice of ``y · silu(z)``, summed over the ranks on rank 0 (``n``, the
    whole row's width, divides it) and copied back, scales each slice,
    rounded once to ``y``'s type."""
    xfs = [y.float() * F.silu(z.float()) for y, z in zip(ys, zs)]
    var = psum([xf.square().sum(dim=-1, keepdim=True) for xf in xfs],
               AXES) / n
    return [(xf * torch.rsqrt(v + eps) * w.float()).to(y.dtype)
            for xf, v, w, y in zip(xfs, broadcast(var, [x.device
                                                       for x in xfs]),
                                   ws, ys)]


def mamba(cfg: ArchConfig, lps: Sequence[Params],
          xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The Mamba2 block (``mamba_block``) over the ranks' heads, each
    rank's normed input on its device: its columns of ``in_proj``, conv,
    the SSD scan over its heads (:func:`ssm.mamba_scan`), the gated norm
    over the whole ``d_inner`` (:func:`gated_rms_norm`) and its rows of
    ``out_proj``; the partials summed on rank 0 in rank order."""
    outs = [mamba_scan(cfg, lp, x) for lp, x in zip(lps, xs)]
    ys = gated_rms_norm([o[0] for o in outs], [o[1] for o in outs],
                        [lp["norm_w"] for lp in lps], cfg.norm_eps,
                        cfg.ssm_d_inner)
    return out_proj_sum(ys, lps)


def out_proj_sum(ys: Sequence[torch.Tensor], lps: Sequence[Params]
                 ) -> torch.Tensor:
    """The Mamba2 block's output: each rank's normed ``y`` through its rows
    of ``out_proj`` (:func:`layers.partial_product`), summed on rank 0 and
    rounded once to ``y``'s type."""
    return psum([L.partial_product(y, lp["out_proj"], len(lps))
                 for y, lp in zip(ys, lps)], AXES).to(ys[0].dtype)


def mamba_layer(cfg: ArchConfig, lps: Sequence[Params], h: torch.Tensor
                ) -> torch.Tensor:
    """One pre-norm Mamba2 layer over the ranks' layer trees, the residual
    ``h`` on rank 0's device."""
    x = L.rms_norm(h, lps[0]["ln"], cfg.norm_eps)
    return h + mamba(cfg, [lp["mamba"] for lp in lps],
                     broadcast(x, [shard_device(lp) for lp in lps]))


def shared_block(cfg: ArchConfig, sps: Sequence[Params],
                 w_concat: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                 positions: Sequence[torch.Tensor], chunk: int = 1024
                 ) -> torch.Tensor:
    """The hybrid's shared block over the ranks' trees ``sps`` (its
    attention heads and d_ff slice; ``ln1``/``ln2`` whole): ``concat([h,
    h0]) @ w_concat`` on rank 0, then the attention and MLP passes."""
    devices = [shard_device(sp) for sp in sps]
    x = torch.cat([h, h0], dim=-1) @ w_concat
    a, _, _ = attention(cfg, [sp["attn"] for sp in sps],
                        broadcast(L.rms_norm(x, sps[0]["ln1"], cfg.norm_eps),
                                  devices), positions, chunk)
    x = x + a
    m, _ = ffn(cfg, sps, broadcast(L.rms_norm(x, sps[0]["ln2"],
                                              cfg.norm_eps), devices))
    return h + x + m


def gathered_logits(cfg: ArchConfig, trees: Sequence[Params],
                    h: torch.Tensor) -> torch.Tensor:
    """A vocab-sharded head on ``h`` (shard 0's device): each shard's vocab
    columns of ``lm_head``, gathered in shard order, then split per
    codebook."""
    hs = broadcast(h, [shard_device(t) for t in trees])
    out = all_gather([x @ t["lm_head"] for x, t in zip(hs, trees)], dim=-1,
                     axes=AXES)
    if cfg.num_codebooks > 1:
        out = out.unflatten(-1, (cfg.num_codebooks, cfg.vocab_size))
    return out
