"""Optimizers, schedules, clipping and gradient compression of the port,
over its parameter trees (nested dicts of tensors) — counterparts of
``repro.optim``.  Every update is out of place: it returns new tensors and
never writes into the parameters, gradients or state it is given."""

from repro_torch.optim.adamw import adamw
from repro_torch.optim.sgd import sgd_momentum
from repro_torch.optim.schedules import constant, cosine_warmup, linear_warmup
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.base import Optimizer, apply_updates
from repro_torch.optim.compress import (
    ErrorFeedbackState,
    compressed_gradients,
    int8_compress,
    int8_decompress,
    topk_compress,
)

__all__ = [
    "adamw", "sgd_momentum", "constant", "cosine_warmup", "linear_warmup",
    "clip_by_global_norm", "global_norm", "Optimizer", "apply_updates",
    "ErrorFeedbackState", "compressed_gradients", "int8_compress",
    "int8_decompress", "topk_compress",
]
