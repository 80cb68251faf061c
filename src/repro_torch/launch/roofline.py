"""Roofline terms of one dry-run cell, on the H100.

The port's counterpart of ``repro/launch/roofline.py``.  Three terms per
(arch × shape × mesh), all in seconds:

  compute    = FLOPs                / (chips × peak FLOP/s)
  memory     = bytes accessed       / (chips × HBM bytes/s)
  collective = Σ over mesh axes of that axes' collective bytes
                                    / (chips × the link those axes cross)

The FLOPs, bytes and collective bytes come from the op counter
(``launch/op_costs.py``) where the JAX package reads XLA's HLO; the
``hlo_*`` field names are kept so one ``report`` reads both packages'
records (a port record says ``"counter": "torch_dispatch"``).

**Links.**  Mesh positions lie row-major over the axes, 8 consecutive
positions to a node (``launch/mesh.py``).  A collective over a set of axes
runs within groups of positions that differ only along those axes; where
every such group lies inside one node, its bytes cross NVLink
(:data:`NVLINK_BW`), otherwise the node network (:data:`NODE_BW`).  On the
16×16 production mesh a ``model`` group is 16 consecutive positions, two
nodes, so every axis there crosses the node network; on a mesh of at most
8 positions every axis stays on NVLink.  A collective that names no axes
is charged the node network.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence

import numpy as np

from repro_torch.launch.mesh import (
    HBM_BW,
    NODE_BW,
    NODE_CARDS,
    NVLINK_BW,
    PEAK_FLOPS_BF16,
)


def link_bw(mesh_shape: Dict[str, int], axes: Sequence[str]) -> float:
    """The bytes/s per card of the link a collective over ``axes`` of a
    mesh of ``mesh_shape`` (axis -> size, in mesh order) crosses."""
    names = list(mesh_shape)
    ax = [names.index(a) for a in axes if a in names]
    if not ax:
        return NODE_BW
    sizes = tuple(mesh_shape.values())
    node = np.arange(math.prod(sizes)).reshape(sizes) // NODE_CARDS
    rest = [i for i in range(len(sizes)) if i not in ax]
    groups = node.transpose(rest + ax).reshape(-1, math.prod(
        sizes[i] for i in ax))
    return NVLINK_BW if bool((groups == groups[:, :1]).all()) else NODE_BW


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_by_op: Dict[str, float]
    model_flops: float
    bytes_per_device: Optional[float]
    hlo_bytes_raw: Optional[float] = None
    bytes_vmem_tagged: Optional[float] = None
    #: collective bytes by the axes they span (``"/"``-joined), and the
    #: mesh (axis -> size) they lie on: the link of each
    coll_by_axes: Dict[str, float] = field(default_factory=dict)
    mesh_shape: Dict[str, int] = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS_BF16)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return sum(
            b / (self.chips * link_bw(self.mesh_shape,
                                      [a for a in axes.split("/") if a]))
            for axes, b in self.coll_by_axes.items())

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful work / achievable step time: MODEL_FLOPS/(chips·peak)
        over the largest roofline term."""
        t_use = self.model_flops / (self.chips * PEAK_FLOPS_BF16)
        t_step = max(self.t_compute, self.t_memory, self.t_collective)
        return t_use / t_step if t_step else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "hlo_bytes_raw": self.hlo_bytes_raw,
            "bytes_vmem_tagged": self.bytes_vmem_tagged,
            "coll_bytes": self.coll_bytes, "coll_by_op": self.coll_by_op,
            "model_flops": self.model_flops,
            "bytes_per_device": self.bytes_per_device,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "coll_by_axes": self.coll_by_axes,
        }


def model_flops_for(cfg, shape_spec, kind: str) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference), N = active params.

    D = tokens processed by the step: B·S for train/prefill, B for decode.
    """
    n = cfg.active_param_count() if cfg.is_moe else cfg.param_count()
    if kind == "train":
        d = shape_spec.global_batch * shape_spec.seq_len
        return 6.0 * n * d
    if kind == "prefill":
        d = shape_spec.global_batch * shape_spec.seq_len
        return 2.0 * n * d
    # decode: one token per sequence
    return 2.0 * n * shape_spec.global_batch
