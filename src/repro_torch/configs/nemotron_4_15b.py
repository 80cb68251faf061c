"""nemotron-4-15b — dense, GQA, squared-ReLU MLP [arXiv:2402.16819; unverified]."""

from repro_torch.configs.base import ArchConfig, register

NEMOTRON_4_15B = register(ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    mlp_activation="sqrelu",   # squared ReLU, no gating
    rope_theta=10_000.0,
    source="[arXiv:2402.16819; unverified]",
))
