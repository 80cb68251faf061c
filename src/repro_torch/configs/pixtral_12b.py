"""pixtral-12b — VLM: pixtral-ViT frontend (stub) + mistral-nemo decoder
[hf:mistralai/Pixtral-12B-2409; unverified].

The modality frontend is a stub: precomputed patch embeddings
(``Model.prefill(frontend_embed=)``) occupy the first ``frontend_tokens``
positions of the sequence.
"""

from repro_torch.configs.base import ArchConfig, register

PIXTRAL_12B = register(ArchConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    mlp_activation="swiglu",
    frontend="vlm_stub",
    frontend_tokens=1024,      # one 1024-patch image per sequence
    source="[hf:mistralai/Pixtral-12B-2409; unverified]",
))
