"""repro_torch — the PyTorch/CUDA port of the branchable serving system.

A package of its own beside the JAX reference ``repro``: it imports
``torch``, numpy and the standard library, never ``jax`` and nothing of
``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the attention hot path goes through hand-written Hopper
kernels (``repro_torch.kernels``).
"""
