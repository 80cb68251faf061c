"""Hand-written Hopper kernels of the port, each beside its plain version.

* ``paged_attention`` — paged chunk attention (decode, verify, suffix
  prefill over CoW KV pages) and cached-only decode attention (the legacy
  ``attn_impl="ref"`` step), one CUDA C++ page walk for sm_90a.
* ``flash_attention`` — causal GQA flash attention forward (dense
  prefill), CUDA C++ for sm_90a.
* ``ssd_scan`` — the Mamba2 SSD chunked scan (SSM prefill), CUDA C++ for
  sm_90a.

A wrapper runs its plain PyTorch version only for CPU tensors; for CUDA
tensors it launches its kernel or raises; for ``meta`` tensors (the dry
run's shape-only pass) it returns the outputs' shapes and reports its
kernel's work (``ops.cost``) to the active op counter.
"""

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import (
    paged_attention,
    paged_chunk_attention,
)
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = ["flash_attention", "paged_attention",
           "paged_chunk_attention", "ssd_scan"]
