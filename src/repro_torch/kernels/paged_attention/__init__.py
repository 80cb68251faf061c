from repro_torch.kernels.paged_attention.ops import (
    paged_attention,
    paged_chunk_attention,
)

__all__ = ["paged_attention", "paged_chunk_attention"]
