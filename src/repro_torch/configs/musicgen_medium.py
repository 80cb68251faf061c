"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

The EnCodec frontend is a stub: inputs are precomputed
frame token ids across ``num_codebooks`` parallel codebooks; the model
sums per-codebook embeddings and predicts all codebooks per position.
"""

from repro_torch.configs.base import ArchConfig, register

MUSICGEN_MEDIUM = register(ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,           # MHA
    d_ff=6144,
    vocab_size=2048,           # per-codebook EnCodec vocabulary
    mlp_activation="geglu",
    frontend="audio_stub",
    num_codebooks=4,
    source="[arXiv:2306.05284; hf]",
))
