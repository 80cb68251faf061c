"""stablelm-12b — dense GQA [hf:stabilityai/stablelm-2-1_6b; hf]."""

from repro_torch.configs.base import ArchConfig, register

STABLELM_12B = register(ArchConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    mlp_activation="swiglu",
    source="[hf:stabilityai/stablelm-2-1_6b; hf]",
))
