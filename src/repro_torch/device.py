"""Where the port's entry points run: ``cuda`` unless the caller names a
device; without CUDA they raise instead of falling back to the CPU."""

from __future__ import annotations

from typing import Any

import torch


def resolve_device(device: Any = None) -> torch.device:
    """``cuda`` unless the caller names a device; no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass "
                "device='cpu' explicitly to run its plain versions")
        device = "cuda"
    return torch.device(device)
