"""Op-level cost accounting of one step: the port's counterpart of the JAX
package's ``launch/hlo_costs.py``.

There is no HLO in PyTorch.  :class:`OpCounter` is a ``TorchDispatchMode``
that sees every aten op a step issues (on ``meta`` tensors in the dry run,
on real ones in a CPU test) and adds up:

* **FLOPs**: per aten op by ``torch.utils.flop_counter``'s formulas (the
  matmuls, batched matmuls and convolutions; elementwise FLOPs are noise at
  roofline granularity, as ``hlo_costs`` counts only dots), plus each
  kernel wrapper's reported operations (:func:`repro_torch.accounting.
  kernel`: a wrapper's launch is opaque, and on ``meta`` it launches
  nothing).
* **Bytes accessed**: per aten op its tensor inputs and outputs, each once.
  That is the eager port's memory term: every eager op reads and writes
  HBM, where XLA's fusions kept their internals on chip.  View ops and
  allocations that write nothing count nothing; a kernel counts what its
  wrapper reports (each input read once, each output written once).
* **Collectives**: what :mod:`repro_torch.distributed.collectives` and the
  block gathers of :mod:`repro_torch.distributed.blocked` report, by op and
  by the mesh axes they span (``hlo_costs``' accounting: the output-shape
  bytes per participating device of the SPMD collective each call stands
  for, not the host-driven copies that implement it).
* **Peak live bytes**: the bytes of the outputs of the ops issued inside a
  data position's or a microbatch's iteration (``accounting.repeats``)
  alive at once (each tracked until it is freed; views and in-place
  results share their inputs' storage): the counter's estimate of the
  activations.

Every number is a total over the devices whose work the counter saw (a
collective counts once per participating device); inside
:func:`repro_torch.accounting.scaled` regions everything counts that many
times.  :meth:`OpCounter.cost` returns an :class:`OpCost` with the fields
of ``HloCost`` that the dry run reads, and a per-op breakdown (op × first
output shape) for ``profile_cell``.
"""

from __future__ import annotations

import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import accounting

#: ops that write nothing (an allocation's contents are undefined) or move
#: no data, beside every view op
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "_unsafe_view", "_reshape_alias", "resize_", "set_"}
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided"}


def _tensors(tree: Any):
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _nbytes(x: torch.Tensor) -> int:
    """The bytes of the distinct elements ``x`` addresses (a broadcast dim,
    stride 0, reads its elements once)."""
    n = 1
    for size, stride in zip(x.shape, x.stride()):
        if stride:
            n *= size
    return n * x.element_size()


@dataclass
class OpCost:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    coll_bytes_by_op: Dict[str, float] = field(default_factory=dict)
    coll_count_by_op: Dict[str, float] = field(default_factory=dict)
    coll_bytes_by_axes: Dict[Tuple[str, ...], float] = field(
        default_factory=dict)
    kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)
    bytes_by: Counter = field(default_factory=Counter)
    flops_by: Counter = field(default_factory=Counter)
    coll_by: Counter = field(default_factory=Counter)
    peak_live_bytes: float = 0.0
    ops: float = 0.0

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll_bytes_by_op.values())

    def scaled(self, k: float) -> "OpCost":
        """Every total divided by ``k`` (per device from a total over
        ``k`` devices); the peak is left as it is."""
        def div(d):
            return type(d)({key: v / k for key, v in d.items()})
        return OpCost(
            flops=self.flops / k, bytes_accessed=self.bytes_accessed / k,
            coll_bytes_by_op=div(self.coll_bytes_by_op),
            coll_count_by_op=div(self.coll_count_by_op),
            coll_bytes_by_axes=div(self.coll_bytes_by_axes),
            kernels={n: div(v) for n, v in self.kernels.items()},
            bytes_by=div(self.bytes_by), flops_by=div(self.flops_by),
            coll_by=div(self.coll_by), peak_live_bytes=self.peak_live_bytes,
            ops=self.ops / k)


class OpCounter(TorchDispatchMode):
    """Counts the ops and reported work of everything run inside it."""

    def __init__(self):
        super().__init__()
        self._cost = OpCost()
        self._live = 0

    # -- the dispatch mode ------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.__name__.split(".")[0]
        outs = _tensors(out)
        if not func.is_view and name not in _FREE:
            w = accounting.scale()
            c = self._cost
            nbytes = (sum(_nbytes(x) for x in _tensors((args, kwargs)))
                      + sum(_nbytes(x) for x in outs))
            key = name
            if outs:
                o = outs[0]
                key = f"{name} {str(o.dtype).replace('torch.', '')}" \
                      f"{list(o.shape)}"
            c.bytes_accessed += nbytes * w
            c.bytes_by[key] += nbytes * w
            c.ops += w
            fn = flop_registry.get(func.overloadpacket)
            if fn is not None:
                f = fn(*args, **kwargs, out_val=out) * w
                c.flops += f
                c.flops_by[key] += f
        if accounting.in_repeat() and (
                name in _ALLOC or (not func.is_view and all(
                    r.alias_info is None for r in func._schema.returns))):
            self._track(outs)
        return out

    def _track(self, outs) -> None:
        for x in outs:
            n = _nbytes(x)
            self._live += n
            self._cost.peak_live_bytes = max(self._cost.peak_live_bytes,
                                             self._live)
            weakref.finalize(x, self._free, n)

    def _free(self, n: int) -> None:
        self._live -= n

    # -- what the kernels and collectives report -------------------------
    def add_kernel(self, name: str, nbytes: float, flops: float,
                   weight: float) -> None:
        c = self._cost
        c.flops += flops * weight
        c.bytes_accessed += nbytes * weight
        k = c.kernels.setdefault(name, {"calls": 0.0, "bytes": 0.0,
                                        "flops": 0.0})
        k["calls"] += weight
        k["bytes"] += nbytes * weight
        k["flops"] += flops * weight
        c.bytes_by[f"kernel {name}"] += nbytes * weight
        c.flops_by[f"kernel {name}"] += flops * weight

    def add_collective(self, op: str, nbytes: float, participants: int,
                       axes: Tuple[str, ...], weight: float) -> None:
        c = self._cost
        total = nbytes * participants * weight
        c.coll_bytes_by_op[op] = c.coll_bytes_by_op.get(op, 0.0) + total
        c.coll_count_by_op[op] = (c.coll_count_by_op.get(op, 0.0)
                                  + participants * weight)
        c.coll_bytes_by_axes[axes] = (c.coll_bytes_by_axes.get(axes, 0.0)
                                      + total)
        c.coll_by[f"{op} over {'/'.join(axes) or '?'} {int(nbytes)}B"] += total

    # -- lifetime ----------------------------------------------------------
    def __enter__(self):
        accounting.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        accounting.COUNTERS.remove(self)
        return super().__exit__(*exc)

    def cost(self) -> OpCost:
        return self._cost
