"""Model definitions of the port: every family of the JAX package's
``repro.models`` (dense / MoE / SSM / hybrid / VLM / audio) in PyTorch."""

from repro_torch.models.model import (
    Model,
    decode_state_specs,
    init_params,
)

__all__ = ["Model", "decode_state_specs", "init_params"]
