"""Branch scorers — the "explore" half of fork/explore/commit.

A scorer maps a :class:`~repro_torch.explore_ctx.context.BranchContext` to a
float; policies rank sibling branches with it and commit the winner.
In production this is a verifier, reward model or unit-test harness;
these built-ins are cheap stand-ins over the generated token ids so the
policies (and their benchmarks) run hermetically.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from repro_torch.explore_ctx.context import BranchContext

Scorer = Callable[[BranchContext], float]


def mean_token_score(ctx: BranchContext) -> float:
    """Mean generated token id — the seed example's stand-in reward."""
    gen = ctx.generated()
    return float(np.mean(gen)) if gen else float("-inf")


def diversity_score(ctx: BranchContext) -> float:
    """Fraction of distinct tokens in the generation (anti-loop prior)."""
    gen = ctx.generated()
    return len(set(gen)) / len(gen) if gen else float("-inf")


def combined_score(*weighted: "tuple[float, Scorer]") -> Scorer:
    """Weighted sum of scorers: ``combined_score((1.0, a), (0.5, b))``."""

    def score(ctx: BranchContext) -> float:
        return sum(w * f(ctx) for w, f in weighted)

    return score


def lcp_len(a: Sequence[int], b: Sequence[int]) -> int:
    """Longest-common-prefix length (speculative-decode verification)."""
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


__all__ = ["Scorer", "combined_score", "diversity_score", "lcp_len",
           "mean_token_score"]
