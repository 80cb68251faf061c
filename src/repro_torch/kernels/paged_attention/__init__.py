from repro_torch.kernels.paged_attention.ops import paged_chunk_attention

__all__ = ["paged_chunk_attention"]
