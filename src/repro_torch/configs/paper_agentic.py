"""paper-agentic — the paper's own workload: a small serving model whose
KV cache is branched for agentic exploration (fork N continuations,
first-commit-wins).  Used by examples/agentic_serve.py and the serving
benchmarks; small enough to run real forward passes on CPU.
"""

from repro_torch.configs.base import ArchConfig, register

PAPER_AGENTIC = register(ArchConfig(
    name="paper-agentic",
    family="dense",
    num_layers=4,
    d_model=256,
    num_heads=8,
    num_kv_heads=4,
    d_ff=1024,
    vocab_size=512,
    mlp_activation="swiglu",
    source="[paper §6 workload analogue]",
))
