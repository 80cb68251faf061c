"""mamba2-2.7b — attention-free SSD (state-space duality) [arXiv:2405.21060; unverified]."""

from repro_torch.configs.base import ArchConfig, register

MAMBA2_2_7B = register(ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,               # attention-free
    num_kv_heads=0,
    d_ff=0,                    # Mamba2 blocks have no separate MLP
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,           # d_inner 5120 -> 80 SSD heads
    ssm_expand=2,
    ssm_chunk=128,
    source="[arXiv:2405.21060; unverified]",
))
