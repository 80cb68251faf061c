"""The one general traffic generator: every mix is a file of parameters.

A closed loop: ``sessions`` agents, think time 0.  A session's
context is a system prompt shared by every session plus a history of its
own; each turn appends a tool output to the context and explores
``branches`` continuations; the winner's tokens plus the next tool output
form the next turn's suffix.  A context that would outgrow
``max_context_tokens`` starts again from the system prompt and a fresh
history (the agent compacts).

Sizes are the mix's, the same for every run seed: each quantity is a pool
of stratified quantiles of its distribution put in an order drawn from the
mix's ``base_seed``.  The run's seed draws the token ids (and the
weights), so that runs of different seeds do the same work."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

#: entries in each size pool; a run uses far fewer
POOL = 4096


def stratified(lo: float, hi: float, dist: str, n: int = POOL) -> np.ndarray:
    """``n`` evenly spaced quantiles of a distribution on ``[lo, hi]``,
    rounded to whole tokens."""
    q = (np.arange(n) + 0.5) / n
    if dist == "loguniform":
        v = np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))
    elif dist == "uniform":
        v = lo + q * (hi - lo)
    else:
        raise ValueError(f"unknown distribution {dist!r}")
    return np.rint(v).astype(np.int64)


def _pool(values: np.ndarray, seed: int, stream: int) -> np.ndarray:
    return np.random.default_rng([seed, stream]).permutation(values)


@dataclass
class Turn:
    """One request: an agent's turn."""

    idx: int
    session: int
    prompt: List[int]
    branch_tokens: int
    # filled by the harness
    submit_ns: int = 0
    admit_ns: int = 0
    first_ns: int = 0
    done_ns: int = 0
    in_window: bool = False
    branches: List[List[int]] = field(default_factory=list)
    greedy: List[bool] = field(default_factory=list)
    result: Optional[List[int]] = None
    error: Optional[str] = None
    degraded: bool = False


class ClosedLoop:
    """Agent sessions over a shared system prompt (see the module doc)."""

    def __init__(self, p: Dict[str, Any], seed: int, vocab: int):
        self.p, self.seed, self.vocab = p, seed, vocab
        self.sessions = int(p["sessions"])
        self.system = self._tokens(np.random.default_rng([seed, 0]),
                                   int(p["shared_prefix_tokens"]))
        self._rng = [np.random.default_rng([seed, 1, i])
                     for i in range(self.sessions)]
        base = p.get("base_seed", 0)
        self._history = _pool(stratified(*p["history_tokens"]), base, 2)
        self._tool = _pool(stratified(*p["tool_tokens"]), base, 3)
        self._branch = _pool(stratified(*p["branch_tokens"]), base, 4)
        self._draws = [0] * self.sessions
        self._turns = 0

    def _tokens(self, rng: np.random.Generator, n: int) -> List[int]:
        return rng.integers(0, self.vocab, n).tolist()

    def _size(self, pool: np.ndarray, session: int) -> int:
        j = self._draws[session]
        return int(pool[(session + j * self.sessions) % len(pool)])

    def _turn(self, session: int, context: Optional[List[int]]) -> Turn:
        rng = self._rng[session]
        tool = self._size(self._tool, session)
        branch = self._size(self._branch, session)
        if context is not None and (len(context) + tool + branch
                                    > self.p["max_context_tokens"]):
            context = None
        if context is None:
            hist = self._size(self._history, session)
            context = self.system + self._tokens(rng, hist)
        self._draws[session] += 1
        turn = Turn(idx=self._turns, session=session,
                    prompt=context + self._tokens(rng, tool),
                    branch_tokens=branch)
        self._turns += 1
        return turn

    def first_turn(self, session: int) -> Turn:
        return self._turn(session, None)

    def next_turn(self, session: int, context: List[int]) -> Turn:
        """The session's next turn after a turn that left ``context`` (the
        request's tokens with the committed winner's)."""
        return self._turn(session, list(context))
