"""Elastic scaling of the port: re-mesh and re-place on a change of the
device count.

Counterpart of ``repro/runtime/elastic.py``.  Checkpoints are logical
(mesh-free manifests of full arrays), so scaling is: drain, commit a
checkpoint, ``plan_mesh(surviving_devices)``, restore onto the new mesh.
For in-flight resharding (no restart) :func:`reshard` stores every leaf
as the new plan's blocks: each new block is gathered from the pieces of
the old blocks it covers (a block that stays where it is is not copied),
so no leaf is ever whole on one card on the way.

A device list is a list of ``torch.device`` s (or their names) and may
name one device several times: one host process drives every position,
so ``["cuda:0"] * 4`` is a mesh of four positions on one card and
``["cpu"] * 8`` one of eight on the CPU.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.mesh import DeviceMesh, ParallelPlan, \
    plan_from_mesh
from repro_torch.distributed.sharding import shard_params


def factor_mesh(n_devices: int, prefer_model: int = 16
                ) -> Tuple[int, int]:
    """Largest model axis ≤ prefer_model that divides n_devices."""
    model = min(prefer_model, n_devices)
    while model > 1 and n_devices % model:
        model -= 1
    return n_devices // model, model


def plan_mesh(devices: Optional[Sequence[Any]] = None,
              prefer_model: int = 16,
              multi_pod: bool = False) -> ParallelPlan:
    """The best-fit ``(data, model)`` mesh, or ``(pod, data, model)`` with
    ``multi_pod``, over ``devices`` in order (every visible CUDA card when
    none are given; without CUDA that raises: nothing falls back to the
    CPU)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "plan_mesh without a device list plans over the visible "
                "CUDA cards, and there are none; name the devices "
                "(devices=['cpu'] * n runs n positions on the CPU)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    if multi_pod and n % 2 == 0 and n >= 4:
        data, model = factor_mesh(n // 2, prefer_model)
        mesh = DeviceMesh(arr.reshape(2, data, model),
                          ("pod", "data", "model"))
    else:
        data, model = factor_mesh(n, prefer_model)
        mesh = DeviceMesh(arr.reshape(data, model), ("data", "model"))
    return plan_from_mesh(mesh)


def reshard(cfg: ArchConfig, state: Any, new_plan: ParallelPlan) -> Any:
    """A params-shaped tree (tensors, or another plan's blocks) stored as
    the new plan's blocks (``shard_params``)."""
    return shard_params(cfg, new_plan, state)


class ElasticController:
    """Drives shrink/grow events: each event re-plans the mesh and
    re-places (or restores) the training state.

    On a real cluster the device list comes from the coordinator's health
    service; tests drive it with explicit device lists.
    """

    def __init__(self, cfg: ArchConfig, prefer_model: int = 16):
        self.cfg = cfg
        self.prefer_model = prefer_model
        self.events: List[Tuple[int, Tuple[int, ...]]] = []

    def remesh(self, state: Any, devices: Sequence[Any]
               ) -> Tuple[Any, ParallelPlan]:
        plan = plan_mesh(devices, self.prefer_model)
        new_state = reshard(self.cfg, state, plan)
        self.events.append((len(devices), tuple(plan.mesh.shape.values())))
        return new_state, plan
