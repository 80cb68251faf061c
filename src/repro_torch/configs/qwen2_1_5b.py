"""qwen2-1.5b — dense GQA with QKV bias [arXiv:2407.10671; hf]."""

from repro_torch.configs.base import ArchConfig, register

QWEN2_1_5B = register(ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    mlp_activation="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    source="[arXiv:2407.10671; hf]",
))
