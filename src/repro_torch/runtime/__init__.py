"""Serving runtime of the port (single device, fused path)."""

from repro_torch.runtime.serve_loop import ServeEngine, TokenDomain

__all__ = ["ServeEngine", "TokenDomain"]
