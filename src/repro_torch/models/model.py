"""Model facade of the port: one object per architecture config.

``loss`` is the training objective (the chunked cross-entropy plus the
weighted MoE aux loss), differentiable through the flash attention and SSD
scan kernels.  Every family the JAX package registers: dense, vlm, audio and moe (a
contiguous KV cache, written in place by ``decode_step``), ssm (the
recurrent state, stepped out of place) and hybrid (both: the Mamba2 state
out of place, the shared block's KV in place).  The paged ``ServeEngine``
serves the dense, vlm (text) and moe families; ssm and hybrid branch
their caches through ``BranchStore``.

With a training ``plan`` (``plan_from_mesh``), ``loss`` is the one-process
sharded pass over the mesh (``models/transformer.py``), on parameters
stored whole or as blocks (``distributed.sharding.shard_params``): each
data position's token sum and count (:meth:`Model.position_loss`),
combined in position order (:meth:`Model.combine`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.collectives import psum
from repro_torch.distributed.mesh import SINGLE_DEVICE, ParallelPlan
from repro_torch.distributed.sharding import ShardDraw, serve_specs
from repro_torch.models import decode as D
from repro_torch.models import plan_decode as PD
from repro_torch.models import transformer as T
from repro_torch.models.layers import META, init_generator

Params = Dict[str, Any]

# re-exported for the launch layer, as the JAX package's
decode_state_specs = D.decode_state_specs
init_decode_state = D.init_decode_state


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                *, device: Any = None, shards: Optional[ParallelPlan] = None
                ) -> Any:
    """Random weights from a seeded generator, on its device; with no
    generator and ``device="meta"``, the tree's shapes and types only
    (nothing allocated or drawn: the dry run's ``jax.eval_shape``).  With
    ``shards`` (a serving plan: ``serving_plan(mesh)``), one tree per tp
    shard on the plan's devices, each leaf cut by the serving engine's
    specs as it is drawn: bit for bit ``shard_params`` of the whole init
    from the same generator, with no device holding the whole tree."""
    gen = init_generator(generator, device)
    if shards is None:
        return T.init_transformer(cfg, gen)
    like = T.init_transformer(cfg, META)
    return T.init_transformer(
        cfg, gen, ShardDraw(shards, serve_specs(cfg, shards, like)))


@dataclass
class Model:
    cfg: ArchConfig
    plan: ParallelPlan = field(default_factory=lambda: SINGLE_DEVICE)
    remat: bool = True
    attn_chunk: int = 1024
    loss_chunk: int = 512
    moe_aux_weight: float = 0.01

    def __post_init__(self):
        T.check_servable(self.cfg)

    def init(self, generator: Optional[torch.Generator] = None, *,
             device: Any = None, shards: Optional[ParallelPlan] = None
             ) -> Any:
        """Random weights from a seeded generator, on its device (shapes
        only on ``device="meta"``; one tree per tp shard of a serving plan
        with ``shards``: :func:`init_params`)."""
        return init_params(self.cfg, generator, device=device,
                           shards=shards)

    # -- training ---------------------------------------------------------
    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``batch``: ``tokens``, ``targets`` and, for the VLM stub,
        ``frontend_embed``.  Returns (total, ``{"xent", "moe_aux"}``), f32
        scalars on the batch's device; no host sync.  Over a mesh: each data
        position's :meth:`position_loss`, combined (:meth:`combine`)."""
        if self.plan.is_distributed:
            return self.combine([self.position_loss(params, batch, d)
                                 for d in range(self.plan.dp_size)])
        s = batch["tokens"].shape[1]
        h, aux = T.forward(self.cfg, params, batch["tokens"],
                           batch.get("frontend_embed"), remat=self.remat,
                           attn_chunk=min(self.attn_chunk, s))
        xent = T.token_loss(self.cfg, params, h, batch["targets"],
                            loss_chunk=min(self.loss_chunk, s))
        return xent + self.moe_aux_weight * aux, {"xent": xent,
                                                  "moe_aux": aux}

    def position_loss(self, params: Params, batch: Dict[str, torch.Tensor],
                      d: int) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
        """Data position ``d``'s share of the loss over the plan's mesh: (its
        summed token cross-entropy, its count of positions carrying loss,
        its MoE aux loss), f32 scalars on ``plan.grid[d][0]``."""
        plan = self.plan
        tokens, targets, fe = T.position_rows(
            plan, batch["tokens"], batch["targets"],
            batch.get("frontend_embed"))[d]
        s = tokens.shape[1]
        h, aux = T.position_forward(self.cfg, params, plan, d, tokens, fe,
                                    remat=self.remat,
                                    attn_chunk=min(self.attn_chunk, s))
        nll, count = T.position_nll(self.cfg, params, plan, d, h, targets,
                                    loss_chunk=min(self.loss_chunk, s))
        return nll, count, aux

    def combine(self, parts: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, ``{"xent", "moe_aux"}``) from the data positions'
        :meth:`position_loss` triples, summed in position order on the
        first position's device: the token sums over the counts (the
        single-device loss whatever the mask) and the mean aux loss (the
        GShard convention of the JAX package)."""
        nll, count, aux = (psum(list(x), self.plan.dp_axes)
                           for x in zip(*parts))
        xent = nll / torch.clamp(count, min=1.0)
        aux = aux / len(parts)
        return xent + self.moe_aux_weight * aux, {"xent": xent,
                                                  "moe_aux": aux}

    def prefill(self, params: Params, tokens: torch.Tensor,
                frontend_embed: Optional[torch.Tensor] = None,
                max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The prompt (``frontend_embed``: the VLM stub's patch
        embeddings) -> (last-position logits, decode cache).  Over a plan
        (:mod:`models.plan_decode`): each data position's rows over its
        model positions, the cache stored as blocks."""
        if self.plan.is_distributed:
            return PD.prefill(self.cfg, params, self.plan, tokens,
                              frontend_embed, max_len=max_len,
                              attn_chunk=self.attn_chunk)
        return D.prefill(self.cfg, params, tokens, frontend_embed,
                         max_len=max_len)

    def decode_step(self, params: Params, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, pos: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One token per sequence: in place over a contiguous KV cache,
        out of place over an SSM cache; a hybrid cache's ``conv``/``ssm``
        out of place and its ``k``/``v`` in place (batch restored branches
        by ``torch.cat`` or clone them first).  Over a plan: the cache's
        blocks (:mod:`models.plan_decode`)."""
        if self.plan.is_distributed:
            return PD.decode_step(self.cfg, params, self.plan, cache, tokens,
                                  pos)
        return D.decode_step(self.cfg, params, cache, tokens, pos)

    def init_decode_state(self, batch: int, max_len: int,
                          device: Any = None) -> Dict[str, Any]:
        """A zero cache on ``device``, or over a plan laid out as its
        blocks (``state_shardings``)."""
        if self.plan.is_distributed:
            return PD.init_cache(self.cfg, self.plan, batch, max_len)
        return D.init_decode_state(self.cfg, batch, max_len, device)
