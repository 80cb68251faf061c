"""Assigned input-shape presets and their ``input_specs``.

The port's counterpart of ``repro/configs/shapes.py``: the same four LM
shapes and applicability rule.  ``decode_*`` / ``long_*`` run the decode
step (one new token against a KV cache of ``seq_len``), not the train
step.  ``long_500k`` requires sub-quadratic attention and is only
applicable to SSM/hybrid archs (skips recorded by :func:`cell_applicable`).
A spec is ``{name: (shape, dtype)}``, the port's idiom
(``models.decode.decode_state_specs``), where the JAX package builds
``jax.ShapeDtypeStruct`` s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Is (arch × shape) a runnable cell?  Returns (ok, reason_if_not).

    Rules from the assignment:
    * ``long_500k`` needs sub-quadratic attention → run only for
      SSM/hybrid archs; skip for pure full-attention archs.
    * decode shapes are skipped for encoder-only archs (none assigned).
    """
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            f"{cfg.name} is pure full-attention; long_500k requires "
            "sub-quadratic attention (SSM/hybrid only) — skip per assignment"
        )
    return True, ""


Spec = Tuple[Tuple[int, ...], torch.dtype]


def _token_spec(cfg: ArchConfig, batch: int, seq: int) -> Spec:
    if cfg.num_codebooks > 1:
        return (batch, seq, cfg.num_codebooks), torch.int32
    return (batch, seq), torch.int32


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """``(shape, dtype)`` stand-ins for every model input of this cell (the
    cache a dict of them), allocated nowhere: the dry run makes them
    ``meta`` tensors."""
    from repro_torch.models.decode import decode_state_specs

    b, s = shape.global_batch, shape.seq_len
    dt = torch.bfloat16
    if shape.kind in ("train", "prefill"):
        specs: Dict[str, Any] = {"tokens": _token_spec(cfg, b, s)}
        if shape.kind == "train":
            specs["targets"] = _token_spec(cfg, b, s)
        if cfg.frontend == "vlm_stub":
            specs["frontend_embed"] = ((b, cfg.frontend_tokens, cfg.d_model),
                                       dt)
        return specs
    # decode: one new token against a cache of seq_len
    return {
        "tokens": _token_spec(cfg, b, 1),
        "cache": decode_state_specs(cfg, batch=b, max_len=s),
        "pos": ((b,), torch.int32),
    }
