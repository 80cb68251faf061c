"""zamba2-7b — hybrid: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified].

81 Mamba2 layers; ONE shared attention+MLP block (weights reused) applied
every ``attn_every`` layers on ``concat([h, h0])`` (h0 = embedding output),
following the Zamba shared-block design.
"""

from repro_torch.configs.base import ArchConfig, register

ZAMBA2_7B = register(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,           # MHA in the shared block
    d_ff=14336,
    vocab_size=32000,
    mlp_activation="swiglu",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    attn_every=6,              # 81 layers -> 13 shared-block applications
    source="[arXiv:2411.15242; unverified]",
))
