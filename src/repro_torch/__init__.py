"""repro_torch — the PyTorch/CUDA port of branchx, branch contexts
(fork/explore/commit) for serving and training.

A package of its own beside the JAX reference ``repro``: it imports
``torch``, numpy and the standard library, never ``jax`` and nothing of
``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the attention and SSD hot paths go through hand-written
Hopper kernels (``repro_torch.kernels``).

Submodules are imported lazily (PEP 562) so ``import repro_torch`` stays
cheap; ``__all__`` is the JAX package's public namespace less
``analysis`` (branchlint, which checks the port from the JAX package and
is not ported), and each name resolves on first attribute access.
"""

from importlib import import_module
from typing import Any

__version__ = "1.1.0"

#: the documented public namespace — everything here imports cleanly
__all__ = [
    "__version__",
    "api",
    "checkpoint",
    "configs",
    "core",
    "data",
    "distributed",
    "explore_ctx",
    "fs",
    "kernels",
    "launch",
    "models",
    "obs",
    "optim",
    "runtime",
    "server",
]


def __getattr__(name: str) -> Any:
    if name in __all__:
        return import_module(f"repro_torch.{name}")
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__() -> list:
    return sorted(__all__)
