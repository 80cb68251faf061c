"""qwen3-moe-235b-a22b — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B; hf]."""

from repro_torch.configs.base import ArchConfig, register

QWEN3_MOE_235B_A22B = register(ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,                 # per-expert FFN width
    vocab_size=151936,
    mlp_activation="swiglu",
    num_experts=128,
    experts_per_token=8,
    source="[hf:Qwen/Qwen3-30B-A3B; hf]",
))
