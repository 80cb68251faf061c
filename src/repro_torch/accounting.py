"""How the port's kernels and collectives report their work to an active
op counter, and the dry run's one-of-each switch.

The op counter (:class:`repro_torch.launch.op_costs.OpCounter`) sees every
aten op of a step through a dispatch mode.  Two kinds of work it cannot
see are reported here by the code that issues them:

* a kernel's (:func:`kernel`): a wrapper's launch is one opaque call, and
  on ``meta`` tensors it launches nothing, so each wrapper reports the
  bytes and operations of its kernel from its ``cost`` function;
* a collective's (:func:`collective`): one host process moves the shards'
  tensors with ordinary copies, so :mod:`repro_torch.distributed.
  collectives` and the block gathers of :mod:`repro_torch.distributed.
  blocked` report the SPMD collective each call stands for (the JAX
  package's accounting: the output-shape bytes per participating device,
  ``launch/hlo_costs.py``), with the mesh axes it spans.

With no counter active a report costs one list check.

**One of each** (:func:`repeats`).  The data positions of a step over a
mesh run the same shapes, as do the microbatches of an accumulated step.
Inside :func:`one_of_each` a loop over such repeats runs its first
iteration only, its reports and ops counted as many times as there are
repeats (:func:`scaled`), and hands its result to the others (weight 0).
That is how the dry run counts a full-width cell of 256 positions in
seconds; outside it every iteration runs.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Sequence, Tuple

#: the active counters, innermost last
COUNTERS: List = []
_SCALE = [1.0]
_ONE_OF_EACH = [False]


def active() -> bool:
    return bool(COUNTERS)


def in_repeat() -> bool:
    """Whether the work issued now lies inside a :func:`repeats` loop's
    iteration (a data position's or a microbatch's own work)."""
    return len(_SCALE) > 1


def scale() -> float:
    """How many times the work issued now counts."""
    return _SCALE[-1]


@contextlib.contextmanager
def scaled(weight: float) -> Iterator[None]:
    """Count everything issued inside ``weight`` times (nested regions
    multiply)."""
    _SCALE.append(_SCALE[-1] * weight)
    try:
        yield
    finally:
        _SCALE.pop()


@contextlib.contextmanager
def one_of_each() -> Iterator[None]:
    """Run the first of each :func:`repeats` loop only, counted for all."""
    _ONE_OF_EACH.append(True)
    try:
        yield
    finally:
        _ONE_OF_EACH.pop()


def repeats(n: int) -> List[Tuple[int, int]]:
    """``(i, weight)`` for ``n`` iterations of one shape: ``weight`` 1 for
    each, or inside :func:`one_of_each` ``n`` for the first and 0 (reuse
    the first's result) for the rest."""
    if _ONE_OF_EACH[-1] and n > 1:
        return [(0, n)] + [(i, 0) for i in range(1, n)]
    return [(i, 1) for i in range(n)]


def kernel(name: str, nbytes: float, flops: float) -> None:
    """A kernel's work: the bytes it must move (each input read once, each
    output written once) and its operations."""
    for c in COUNTERS:
        c.add_kernel(name, nbytes, flops, scale())


def collective(op: str, nbytes: float, participants: int,
               axes: Sequence[str] = ()) -> None:
    """One SPMD collective ``op`` (``all-reduce``, ``all-gather``, ...)
    whose output is ``nbytes`` on each of ``participants`` devices, over the
    mesh ``axes`` (empty: not named)."""
    if participants < 1 or not nbytes:
        return
    for c in COUNTERS:
        c.add_collective(op, nbytes, participants, tuple(axes), scale())
