"""Model facade of the port: one object per architecture config.

``loss`` is the training objective (the chunked cross-entropy plus the
weighted MoE aux loss), differentiable through the flash attention and SSD
scan kernels.  Every family the JAX package registers: dense, vlm, audio and moe (a
contiguous KV cache, written in place by ``decode_step``), ssm (the
recurrent state, stepped out of place) and hybrid (both: the Mamba2 state
out of place, the shared block's KV in place).  The paged ``ServeEngine``
serves the dense, vlm (text) and moe families; ssm and hybrid branch
their caches through ``BranchStore``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import decode as D
from repro_torch.models import transformer as T

Params = Dict[str, Any]


@dataclass
class Model:
    cfg: ArchConfig
    remat: bool = True
    attn_chunk: int = 1024
    loss_chunk: int = 512
    moe_aux_weight: float = 0.01

    def __post_init__(self):
        T.check_servable(self.cfg)

    def init(self, generator: torch.Generator) -> Params:
        """Random weights from a seeded generator, on its device."""
        return T.init_transformer(self.cfg, generator)

    # -- training ---------------------------------------------------------
    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``batch``: ``tokens``, ``targets`` and, for the VLM stub,
        ``frontend_embed``.  Returns (total, ``{"xent", "moe_aux"}``), f32
        scalars on the batch's device; no host sync."""
        s = batch["tokens"].shape[1]
        h, aux = T.forward(self.cfg, params, batch["tokens"],
                           batch.get("frontend_embed"), remat=self.remat,
                           attn_chunk=min(self.attn_chunk, s))
        xent = T.token_loss(self.cfg, params, h, batch["targets"],
                            loss_chunk=min(self.loss_chunk, s))
        return xent + self.moe_aux_weight * aux, {"xent": xent,
                                                  "moe_aux": aux}

    def prefill(self, params: Params, tokens: torch.Tensor,
                frontend_embed: Optional[torch.Tensor] = None,
                max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The prompt (``frontend_embed``: the VLM stub's patch
        embeddings) -> (last-position logits, decode cache)."""
        return D.prefill(self.cfg, params, tokens, frontend_embed,
                         max_len=max_len)

    def decode_step(self, params: Params, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, pos: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One token per sequence: in place over a contiguous KV cache,
        out of place over an SSM cache; a hybrid cache's ``conv``/``ssm``
        out of place and its ``k``/``v`` in place (batch restored branches
        by ``torch.cat`` or clone them first)."""
        return D.decode_step(self.cfg, params, cache, tokens, pos)

    def init_decode_state(self, batch: int, max_len: int,
                          device: Any = None) -> Dict[str, torch.Tensor]:
        return D.init_decode_state(self.cfg, batch, max_len, device)
