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
psum`).  Every op is an ordinary differentiable tensor op, so autograd
runs the backward through the copies and sums: a leaf replicated over the
shards (norms, the router) gets the sum of its shards' gradients, and a
sliced leaf the gradients of its slices.  The counterpart of the JAX
package's ``shard_map`` bodies and of XLA's partitioning of
``Model.loss``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.collectives import all_gather, broadcast, psum
from repro_torch.models import layers as L
from repro_torch.models.moe import moe_apply_sharded

Params = Dict[str, Any]


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
    v)."""
    parts, ks, vs = [], [], []
    for lp, x, pos in zip(lps, xs, positions):
        a, k, v = L.attention_block_kv(cfg, lp, x, pos, chunk, attn)
        parts.append(a)
        ks.append(k)
        vs.append(v)
    return psum(parts), ks, vs


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
    return (psum([L.mlp_block(cfg, lp["mlp"], x) for lp, x in zip(lps, xs)]),
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


def gathered_logits(cfg: ArchConfig, trees: Sequence[Params],
                    h: torch.Tensor) -> torch.Tensor:
    """A vocab-sharded head on ``h`` (shard 0's device): each shard's vocab
    columns of ``lm_head``, gathered in shard order, then split per
    codebook."""
    hs = broadcast(h, [shard_device(t) for t in trees])
    out = all_gather([x @ t["lm_head"] for x, t in zip(hs, trees)], dim=-1)
    if cfg.num_codebooks > 1:
        out = out.unflatten(-1, (cfg.num_codebooks, cfg.vocab_size))
    return out
