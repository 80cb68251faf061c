"""Mesh and axis conventions of the port.

Counterparts of ``ParallelPlan``, ``SINGLE_DEVICE``, ``plan_from_mesh``,
``serving_mesh`` and ``serving_plan`` in ``repro/distributed/mesh.py``.
Axis names are the JAX package's:

  ``pod``   — cross-pod data parallelism
  ``data``  — in-pod data parallelism + FSDP parameter sharding
  ``model`` — tensor parallelism (heads / d_ff / experts / vocab)
  ``tp``    — the serving mesh's tensor-parallel axis

A :class:`DeviceMesh` is a named grid of ``torch.device`` s, the
counterpart of a JAX ``Mesh``.  One host process drives every device of
it: a sharded pass issues each shard's work on its own device (launches
are asynchronous, so shards on different cards overlap) and combines the
partial results through :mod:`repro_torch.distributed.collectives`.  A
mesh may name one device several times: every shard then runs there,
which is how the CPU tests and a one-card run drive tensor and data
parallelism.

A :class:`NamedSharding` is the port's counterpart of JAX's: a frozen
(mesh, spec) record saying how a tensor is laid out over the mesh.  It
names each mesh position's block of a leaf (:func:`split_range` along
every dim whose spec entry names an axis or a tuple of axes) and the
device that stores each distinct block: the first position in grid order
that holds it (:meth:`NamedSharding.blocks`).  The port stores a sharded
leaf as those blocks (:class:`repro_torch.distributed.blocked.Blocked`),
each on its owner's device, so the positions along a replicated axis share
one stored copy where the JAX package keeps a replica on each: a card
never stores more bytes of a leaf than the JAX package's would.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class DeviceMesh:
    """Devices laid out on named axes: ``devices`` is an object array of
    ``torch.device`` shaped like the mesh, ``shape`` maps each axis name to
    its size (as ``jax.sharding.Mesh``)."""

    def __init__(self, devices: Any, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(src[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-D devices for axes {axis_names}")
        self.devices = arr
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return (f"DeviceMesh({self.shape}, "
                f"[{', '.join(map(str, self.devices.flat))}])")


def split_range(n: int, parts: int, rank: int) -> Tuple[int, int]:
    """(start, size) of part ``rank`` of ``n`` split into ``parts``
    contiguous parts, the first ``n % parts`` one longer (a dim that does
    not divide still has each index in exactly one part)."""
    base, extra = divmod(n, parts)
    return rank * base + min(rank, extra), base + (rank < extra)


#: a block's region: (start, size) along every dim
Region = Tuple[Tuple[int, int], ...]


@dataclass(frozen=True)
class NamedSharding:
    """How a tensor lies over ``mesh``: ``spec`` has one entry per dim, an
    axis name, a tuple of axis names or ``None`` (replicated).  Dims past
    the spec's end are replicated."""
    mesh: DeviceMesh
    spec: Tuple[Any, ...]

    def _axes(self, dim: int) -> Tuple[str, ...]:
        a = self.spec[dim] if dim < len(self.spec) else None
        if a is None:
            return ()
        return tuple(a) if isinstance(a, (tuple, list)) else (a,)

    def parts(self, ndim: int) -> Tuple[int, ...]:
        """How many blocks each of ``ndim`` dims is cut into."""
        shape = self.mesh.shape
        return tuple(math.prod(shape[a] for a in self._axes(k))
                     for k in range(ndim))

    def block_index(self, position: Tuple[int, ...], ndim: int
                    ) -> Tuple[int, ...]:
        """The block grid index held by the mesh position (its coordinates
        on the mesh's axes): along each dim, the position's index on the
        dim's axes, the first axis major (as ``PartitionSpec``)."""
        names, shape = self.mesh.axis_names, self.mesh.shape
        out = []
        for k in range(ndim):
            i = 0
            for a in self._axes(k):
                i = i * shape[a] + position[names.index(a)]
            out.append(i)
        return tuple(out)

    def blocks(self, shape: Sequence[int]
               ) -> Tuple[Tuple[Region, int], ...]:
        """Every distinct block of a ``shape`` tensor in block-grid order
        (row-major): its region and the flat mesh index of the position
        that stores it, the first in grid order that holds it."""
        ndim = len(shape)
        parts = self.parts(ndim)
        owner: Dict[Tuple[int, ...], int] = {}
        for flat, pos in enumerate(np.ndindex(self.mesh.devices.shape)):
            owner.setdefault(self.block_index(pos, ndim), flat)
        return tuple(
            (tuple(split_range(n, p, i) for n, p, i in zip(shape, parts, ix)),
             owner[ix])
            for ix in np.ndindex(parts))

    def devices(self, shape: Sequence[int]) -> Tuple[torch.device, ...]:
        """The device storing each distinct block, in block-grid order."""
        flat = self.mesh.devices.reshape(-1)
        return tuple(flat[j] for _, j in self.blocks(shape))


@dataclass(frozen=True)
class ParallelPlan:
    mesh: Optional[DeviceMesh] = None
    dp_axes: Tuple[str, ...] = ()
    tp_axis: Optional[str] = None

    @property
    def is_distributed(self) -> bool:
        return self.mesh is not None

    @property
    def dp(self) -> Optional[Tuple[str, ...]]:
        return self.dp_axes if self.dp_axes else None

    @property
    def dp_size(self) -> int:
        if not self.mesh:
            return 1
        n = 1
        for a in self.dp_axes:
            n *= self.mesh.shape[a]
        return n

    @property
    def tp_size(self) -> int:
        return self.mesh.shape[self.tp_axis] if (
            self.mesh and self.tp_axis) else 1

    def constrain(self, x: torch.Tensor, *spec: Any) -> torch.Tensor:
        """``x`` itself: one host process places every shard, so there is
        no propagation to steer (``with_sharding_constraint`` in the JAX
        package).  With a mesh the spec is checked against ``x``'s shape
        first: at most one entry per dim, each naming axes of the mesh."""
        if self.mesh is None:
            return x
        if len(spec) > x.dim():
            raise ValueError(f"spec {spec} has more entries than the "
                             f"{x.dim()} dims of a {tuple(x.shape)} tensor")
        for axis in spec:
            for a in (axis if isinstance(axis, (tuple, list)) else (axis,)):
                if a is not None and a not in self.mesh.axis_names:
                    raise ValueError(f"spec {spec} names {a!r}, not an axis "
                                     f"of {self.mesh.axis_names}")
        return x

    def sharding(self, *spec: Any) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, tuple(spec))

    @property
    def grid(self) -> Tuple[Tuple[torch.device, ...], ...]:
        """Every mesh position's device, one row per data position (the
        data axes flattened in mesh order) and one column per tp rank:
        ``grid[d][r]``.  An axis that is neither (a serving plan's ``data``)
        replicates the work, so its index 0 stands for it, as in
        :attr:`devices`.  The single-device plan has no positions."""
        if self.mesh is None:
            return ()
        names = self.mesh.axis_names
        order = [names.index(a) for a in self.dp_axes]
        order += [names.index(self.tp_axis)] if self.tp_axis else []
        idx = tuple(slice(None) if i in order else 0
                    for i in range(len(names)))
        kept = sorted(order)
        arr = self.mesh.devices[idx].transpose(
            [kept.index(i) for i in order]).reshape(self.dp_size,
                                                    self.tp_size)
        return tuple(tuple(row) for row in arr)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The tp shards' devices in shard order: the tp axis at index 0 of
        every other axis (serving replicates the batch over those).  Empty
        for the single-device plan."""
        if self.mesh is None:
            return ()
        ax = self.mesh.axis_names.index(self.tp_axis)
        idx = [0] * self.mesh.devices.ndim
        idx[ax] = slice(None)
        return tuple(self.mesh.devices[tuple(idx)])


SINGLE_DEVICE = ParallelPlan()


def plan_from_mesh(mesh: DeviceMesh) -> ParallelPlan:
    """The standard plan from a mesh's axis names."""
    axes = mesh.axis_names
    dp = tuple(a for a in ("pod", "data") if a in axes)
    tp = "model" if "model" in axes else None
    if tp is None and "tp" in axes:
        tp = "tp"                      # serving meshes (see serving_mesh)
    return ParallelPlan(mesh=mesh, dp_axes=dp, tp_axis=tp)


# ---------------------------------------------------------------------------
# serving meshes
# ---------------------------------------------------------------------------

def serving_mesh(tp: int, devices: Optional[Sequence[Any]] = None
                 ) -> DeviceMesh:
    """A 1-D tensor-parallel mesh (axis ``tp``) for the serving hot loop.

    ``devices`` lists the shards' devices in order and may repeat one
    (``["cuda:0"] * 2`` runs both shards on one card, ``["cpu"] * 2`` on
    the CPU).  Without it the mesh takes the first ``tp`` visible CUDA
    cards and raises when fewer are visible; nothing falls back to another
    device.  There is no data axis: the decode batch is one continuous
    batch whose host-side branch bookkeeping (block tables, scheduler
    ledger, lifecycle tree) exists once.
    """
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if tp > n:
            raise ValueError(
                f"tp={tp} exceeds the {n} visible CUDA devices; name the "
                "shards' devices (devices=[...], or device= on the engine) "
                "to run several shards on one device")
        devices = [torch.device("cuda", i) for i in range(tp)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != tp:
        raise ValueError(f"tp={tp} needs {tp} devices, got {len(devices)}")
    return DeviceMesh(devices, ("tp",))


def tp_mesh(tp: int, device: Any = None) -> DeviceMesh:
    """The serving mesh of ``ServeEngine(tp=, device=)``: every shard on
    ``device`` where it names one (the CPU, or a card with an index); the
    first ``tp`` cards for no device or a bare ``cuda``."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return serving_mesh(tp, [device] * tp)
    return serving_mesh(tp)


def same_device(a: Any, b: Any) -> bool:
    """Whether two devices are one (a bare ``cuda`` is the current
    card)."""
    def norm(d: Any) -> torch.device:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return norm(a) == norm(b)


def serving_plan(mesh: Optional[DeviceMesh]) -> ParallelPlan:
    """ParallelPlan for a serving mesh (``None`` -> single device).

    Accepts a ``tp``-axis mesh from :func:`serving_mesh` or any mesh with
    a ``model`` axis (its tensor-parallel axis is reused; ``data``/``pod``
    axes are ignored by serving, which keeps the batch replicated).
    """
    if mesh is None:
        return SINGLE_DEVICE
    if "tp" in mesh.axis_names:
        return ParallelPlan(mesh=mesh, dp_axes=(), tp_axis="tp")
    if "model" in mesh.axis_names:
        return ParallelPlan(mesh=mesh, dp_axes=(), tp_axis="model")
    raise ValueError(
        f"serving mesh needs a 'tp' or 'model' axis, got {mesh.axis_names}")
