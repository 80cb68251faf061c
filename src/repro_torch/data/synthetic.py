"""Deterministic, shardable, checkpointable synthetic LM data pipeline.

The port's counterpart of ``repro/data/synthetic.py``: the same Zipf
unigram, bigram shift, shapes, targets, codebooks and VLM
``frontend_embed``.  Its bits come from the counter-based keys of
``repro_torch.core.explore`` on ``(seed, step, shard)`` (integer hashing,
the same bits on the card and on the CPU), not from JAX's threefry, so its
batches are not the JAX package's.  It keeps that pipeline's properties:

* any ``(seed, step, shard)`` batch is reproducible with no state but the
  cursor — the pipeline's checkpoint is a single integer (plus config);
* restarting from a checkpoint replays the exact stream;
* shards never overlap.

Tokens are drawn on the pipeline's device (``cuda`` unless the caller
names one), as ``int64`` (torch's index type; the JAX package's are
``int32``), by inverting the unigram's cumulative distribution at a
24-bit uniform.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

# the package binds the name ``explore`` to the function
_keys = importlib.import_module("repro_torch.core.explore")


class DataState(NamedTuple):
    step: int
    seed: int
    shard: int
    num_shards: int


@dataclass
class SyntheticLMPipeline:
    cfg: ArchConfig
    batch: int                 # per-shard batch
    seq: int
    seed: int = 0
    shard: int = 0
    num_shards: int = 1
    device: Any = None
    _step: int = 0

    def __post_init__(self):
        assert 0 <= self.shard < self.num_shards
        self.device = resolve_device(self.device)
        v = self.cfg.vocab_size
        # fixed Zipf-ish unigram (its CDF, for inversion) + a deterministic
        # bigram shift so the stream has learnable structure
        probs = 1.0 / np.arange(1, v + 1, dtype=np.float64)
        self._cdf = torch.as_tensor(np.cumsum(probs / probs.sum()),
                                    dtype=torch.float32, device=self.device)
        # the seed's key on the CPU's generator, so it is the same key on
        # every device
        self._key = _keys.key_from(self.seed).to(self.device)

    # ------------------------------------------------------------------
    def _gen(self, step: int) -> Dict[str, torch.Tensor]:
        key = _keys.fold_in(_keys.fold_in(self._key, step), self.shard)
        cb = self.cfg.num_codebooks
        v = self.cfg.vocab_size
        shape = ((self.batch, self.seq + 1, cb) if cb > 1
                 else (self.batch, self.seq + 1))
        u = _keys.uniform(key, shape)
        base = torch.clamp(torch.searchsorted(self._cdf, u, right=True),
                           max=v - 1)
        # bigram structure: even positions strongly predict the next token
        rolled = (base * 7 + 13) % v
        odd = torch.arange(self.seq + 1, device=self.device) % 2 == 1
        odd = odd[None, :, None] if cb > 1 else odd[None, :]
        toks = torch.where(odd, rolled, base)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if self.cfg.frontend == "vlm_stub":
            batch["frontend_embed"] = _keys.normal(
                _keys.fold_in(key, 999),
                (self.batch, self.cfg.frontend_tokens, self.cfg.d_model),
                torch.bfloat16)
        return batch

    def next(self) -> Dict[str, torch.Tensor]:
        out = self._gen(self._step)
        self._step += 1
        return out

    def peek(self, step: int) -> Dict[str, torch.Tensor]:
        return self._gen(step)

    # ------------------------------------------------------------------
    # checkpointable cursor
    # ------------------------------------------------------------------
    def state(self) -> DataState:
        return DataState(step=self._step, seed=self.seed, shard=self.shard,
                         num_shards=self.num_shards)

    def restore(self, state: DataState) -> None:
        assert state.seed == self.seed
        self._step = state.step

    @classmethod
    def from_state(cls, cfg: ArchConfig, batch: int, seq: int,
                   state: DataState, device: Any = None
                   ) -> "SyntheticLMPipeline":
        p = cls(cfg, batch, seq, seed=state.seed, shard=state.shard,
                num_shards=state.num_shards, device=device)
        p._step = state.step
        return p
