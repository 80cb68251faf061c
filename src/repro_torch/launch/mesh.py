"""Production meshes (assigned): 16×16 single pod, 2×16×16 multi-pod, and
the H100 constants of the roofline.

The port's counterpart of ``repro/launch/mesh.py``.  ``make_production_mesh``
is a function, so importing this module touches no device.  Its positions
are ``torch.device("meta")`` unless devices are given: the dry run counts
a cell's work on meta tensors, one host process standing for every card.
Positions are laid out row-major over the axes, 8 consecutive positions to
a node (:data:`NODE_CARDS`), as a DGX H100 holds 8 cards.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.distributed.mesh import DeviceMesh

# NVIDIA H100 SXM5 data sheet (dense, no sparsity): the card's peak
# operations/s by input type (f32 outside the tensor cores) and its HBM3
# rate; NVLink 4 per direction between the 8 cards of one node; the node
# network per card across nodes (400 Gb/s, one NIC per card as on a DGX
# H100).
PEAK_FLOPS_BF16 = 989e12        # FLOP/s per card
PEAK_FLOPS_F32 = 67e12          # FLOP/s per card
HBM_BW = 3.35e12                # bytes/s per card
NVLINK_BW = 450e9               # bytes/s per card, one direction
NODE_BW = 50e9                  # bytes/s per card, across nodes
NODE_CARDS = 8                  # cards joined by NVLink in one node


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence[Any]] = None
                         ) -> DeviceMesh:
    """16×16 ``(data, model)`` or 2×16×16 ``(pod, data, model)``, every
    position ``meta`` unless ``devices`` (one per position, row-major) are
    given."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if devices is None:
        return meta_mesh(shape, axes)
    devs = np.empty(len(devices), dtype=object)
    devs[:] = list(devices)
    if devs.size != math.prod(shape):
        raise ValueError(f"{math.prod(shape)} positions, {devs.size} devices")
    return DeviceMesh(devs.reshape(shape), axes)


def meta_mesh(shape: Sequence[int], axes: Sequence[str]) -> DeviceMesh:
    """A mesh of ``shape`` over ``axes`` whose every position is
    ``meta``."""
    devs = np.empty(math.prod(shape), dtype=object)
    devs[:] = [torch.device("meta")] * devs.size
    return DeviceMesh(devs.reshape(tuple(shape)), tuple(axes))
