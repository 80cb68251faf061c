"""Fault tolerance as branch-context semantics — the port's counterpart of
``repro/runtime/fault.py``.

Every training step runs inside a branch forked from the last committed
state (O(1), zero-copy):

* **NaN/divergence rollback** — a non-finite loss aborts the branch; the
  committed origin is untouched (the step is out of place: it never
  writes into the state it reads), the offending batch is skipped.  This
  is the paper's try-and-rollback (n_branches=1) mode (§8).
* **checkpoint/restart** — committed states flow to the BranchFS-backed
  ``CheckpointManager`` (async, delta).  ``FaultTolerantTrainer.restore``
  rebuilds params, optimizer state and the data cursor, replaying the
  exact stream.
* **straggler mitigation** — ``speculative_step`` races N redundant
  executors (threads here) on the same step; first-commit-wins — the
  exclusive commit group means no barrier and no coordination beyond the
  paper's commit race.
* **failure injection** — deterministic hooks for tests (kill an
  executor, corrupt a loss, delay a straggler).

The state may be stored as blocks over a mesh
(``distributed.blocked.Blocked``): the store holds the state as one
object, so the fork, the abort and the commit never look inside it, and a
rolled-back step leaves every block as it was.  A step's metrics come to
the host in one copy (:func:`_to_host`), the step's one host sync, and :func:`_finite` reads the loss there.
``state`` follows the committed state (the store's ROOT), so the trainer
holds one state between steps and two during a step, never the one it
started from as well.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import BranchStore, StaleBranchError
from repro_torch.data.synthetic import SyntheticLMPipeline
from repro_torch.runtime.train_loop import TrainState


def _to_host(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Every metric of a step as a float, in one device-to-host copy (the
    metrics of a step over a mesh gathered onto the first one's card)."""
    names = list(metrics)
    vals = [torch.as_tensor(metrics[k]).float().reshape(()) for k in names]
    vals = torch.stack([v.to(vals[0].device) for v in vals]).tolist()
    return dict(zip(names, vals))


def _finite(x: float) -> bool:
    return math.isfinite(x)


@dataclass
class FaultTolerantTrainer:
    step_fn: Callable[[TrainState, Dict[str, Any]],
                      Tuple[TrainState, Dict[str, Any]]]
    state: TrainState
    data: SyntheticLMPipeline
    ckpt: Optional[CheckpointManager] = None
    ckpt_every: int = 50
    # failure injection hooks (tests)
    corrupt_loss_at: Optional[int] = None
    metrics_log: List[Dict[str, float]] = field(default_factory=list)
    rollbacks: int = 0
    steps_done: int = 0

    def __post_init__(self):
        self.store = BranchStore()
        self.store.write(BranchStore.ROOT, "state", self.state)
        self.store.write(BranchStore.ROOT, "data_step",
                         self.data.state().step)

    # ------------------------------------------------------------------
    @property
    def committed_state(self) -> TrainState:
        return self.store.read(BranchStore.ROOT, "state")

    def run(self, n_steps: int) -> List[Dict[str, float]]:
        for _ in range(n_steps):
            self._one_step()
        if self.ckpt is not None:
            self._checkpoint()
            self.ckpt.wait()
        return self.metrics_log

    def _one_step(self) -> None:
        (branch,) = self.store.fork()
        batch = self.data.next()
        state = self.store.read(branch, "state")
        new_state, metrics = self.step_fn(state, batch)
        host = _to_host(metrics)
        if self.corrupt_loss_at is not None and \
                self.steps_done == self.corrupt_loss_at:
            host["loss"] = float("nan")  # injected fault
        if not _finite(host["loss"]):
            # abort: rollback is free — the committed origin was never
            # touched; the bad batch is skipped (cursor already advanced)
            self.store.abort(branch)
            self.rollbacks += 1
            self.steps_done += 1
            return
        self.store.write(branch, "state", new_state)
        self.store.write(branch, "data_step", self.data.state().step)
        self.store.commit(branch)
        self.state = new_state
        self.steps_done += 1
        self.metrics_log.append(host)
        if self.ckpt is not None and \
                self.steps_done % self.ckpt_every == 0:
            self._checkpoint()

    def _checkpoint(self) -> None:
        state = self.committed_state
        self.ckpt.save_async(
            int(state.step), state,
            extra={"data_step": self.store.read(BranchStore.ROOT,
                                                "data_step")},
        )

    # ------------------------------------------------------------------
    @classmethod
    def restore(
        cls,
        step_fn,
        like_state: TrainState,
        data: SyntheticLMPipeline,
        ckpt: CheckpointManager,
        **kw,
    ) -> "FaultTolerantTrainer":
        """Restart path after a process/node failure."""
        state = ckpt.restore(like_state)
        meta = ckpt.restore_meta()
        data.restore(data.state()._replace(step=meta["extra"]["data_step"]))
        return cls(step_fn=step_fn, state=state, data=data, ckpt=ckpt, **kw)

    # ------------------------------------------------------------------
    # straggler mitigation: speculative redundant execution
    # ------------------------------------------------------------------
    def speculative_step(
        self,
        n_replicas: int = 2,
        delays: Optional[List[float]] = None,
        kill: Optional[List[bool]] = None,
    ) -> Dict[str, Any]:
        """Race ``n_replicas`` executors on the same step; first commit
        wins, losers get -ESTALE.  ``delays``/``kill`` inject stragglers
        and failures."""
        delays = delays or [0.0] * n_replicas
        kill = kill or [False] * n_replicas
        batch = self.data.next()
        branches = self.store.fork(n=n_replicas)
        outcomes: List[Optional[str]] = [None] * n_replicas
        lock = threading.Lock()

        def worker(i: int, bid: int) -> None:
            if kill[i]:
                outcomes[i] = "killed"  # executor died: branch left active,
                return                   # invalidated by the winner's commit
            try:
                time.sleep(delays[i])
                # a straggler whose sibling already committed faults right
                # here (-ESTALE / SIGBUS analogue) — no wasted compute
                state = self.store.read(bid, "state")
                new_state, metrics = self.step_fn(state, batch)
                # the device work is finished before racing to commit
                _to_host(metrics)
                with lock:
                    self.store.write(bid, "state", new_state)
                    self.store.write(bid, "data_step",
                                     self.data.state().step)
                    self.store.commit(bid)
                    self.state = new_state
                outcomes[i] = "committed"
            except StaleBranchError:
                outcomes[i] = "stale"

        threads = [threading.Thread(target=worker, args=(i, b))
                   for i, b in enumerate(branches)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self.steps_done += 1
        return {
            "outcomes": outcomes,
            "statuses": [self.store.status(b) for b in branches],
        }
