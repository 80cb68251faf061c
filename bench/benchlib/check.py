"""The check of ``correct``: what the timed path produced, against the plain
reference, at the timed sizes.

* Every request finished in the window: its branches each decoded their
  budget, and its committed tokens are the prompt plus the tokens of the
  branch with the best mean token id (first-commit-wins, counted exactly).
* A sample drawn from the seed of those requests, the one with the most
  served greedy tokens in it: the reference runs once over each prompt with
  its greedy branch's tokens.  The widest gap by which a served token's
  logit lies below the reference's best at its position, and the share of
  served tokens that are not the reference's first choice, are held to
  the cell's limits (a cell whose widest gap does not separate the program
  from its control holds the share alone).  The first served token reads the prefill's cache (the
  dense pass, or the suffix pass over prefix-cache pages), the rest the
  forked branch's fused decode steps with their copy-on-write faults.
* Every request due in the window came, and none failed."""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from benchlib.traffic import Turn


def finished(turns: Sequence[Turn], t_open: int, t_close: int
             ) -> List[Turn]:
    return [t for t in turns if t.result is not None and not t.degraded
            and t_open <= t.done_ns <= t_close]


def commit_mismatches(turns: Sequence[Turn], branches: int) -> int:
    bad = 0
    for t in turns:
        if len(t.branches) != branches or any(
                len(b) != t.branch_tokens for b in t.branches):
            bad += 1
            continue
        best = max(range(branches), key=lambda i: float(np.mean(
            t.branches[i])))
        bad += t.result != t.prompt + t.branches[best]
    return bad


def sample(turns: Sequence[Turn], seed: int, tokens: int,
           context: int) -> List[Turn]:
    """Turns with a greedy branch: the one with the most served greedy
    tokens (then the longest prompt), then others in an order drawn from
    the seed, until ``tokens`` greedy tokens are in, while the prompts and
    tokens stay within ``context`` positions."""
    cands = sorted((t for t in turns if any(t.greedy)), key=lambda t: t.idx)
    if not cands:
        return []
    first = max(cands, key=lambda t: (t.branch_tokens * sum(t.greedy),
                                      len(t.prompt)))
    out, served, used = [first], first.branch_tokens * sum(first.greedy), \
        len(first.prompt) + first.branch_tokens
    for i in np.random.default_rng([seed, 10]).permutation(len(cands)):
        t = cands[int(i)]
        if served >= tokens:
            break
        size = len(t.prompt) + t.branch_tokens
        if t is first or used + size > context:
            continue
        out.append(t)
        served += t.branch_tokens * sum(t.greedy)
        used += size
    return out


def greedy_rows(turns: Sequence[Turn]
                ) -> Tuple[List[List[int]], List[int], List[List[int]]]:
    """For each greedy branch: the sequence the reference reads (prompt and
    the branch's tokens but the last), where its checked positions start,
    and the served tokens."""
    seqs, starts, served = [], [], []
    for t in turns:
        for g, b in zip(t.greedy, t.branches):
            if g:
                seqs.append(t.prompt + b[:-1])
                starts.append(len(t.prompt) - 1)
                served.append(b)
    return seqs, starts, served


def gap_readings(ref: Any, model: Dict[str, Any], weights: Dict[str, Any],
                 turns: Sequence[Turn]) -> Dict[str, float]:
    """The served greedy tokens under the reference: the widest gap by
    which one's logit lies below the reference's best at its position
    (``max_gap``), the share of them that are not the reference's first
    choice (``flip_share``), and how many were compared."""
    seqs, starts, served = greedy_rows(turns)
    if not seqs:        # nothing to compare: the token floor fails it
        return {"max_gap": 0.0, "flip_share": 0.0, "mean_gap": 0.0,
                "median_branch_gap": 0.0, "greedy_tokens": 0}
    logits = ref.score(model, weights, seqs, starts)
    return readings_of([ref.gaps(lg, s) for lg, s in zip(logits, served)])


def readings_of(gaps: Sequence[Any]) -> Dict[str, float]:
    """The compared numbers of the per-branch gap rows: the widest gap,
    the share of tokens not the reference's first choice, the mean gap over
    all tokens, and the median over branches of each branch's widest."""
    n = sum(len(g) for g in gaps)
    widest = sorted(float(g.max()) for g in gaps)
    return {"max_gap": widest[-1],
            "flip_share": sum(int((g > 0).sum()) for g in gaps) / n,
            "mean_gap": sum(float(g.sum()) for g in gaps) / n,
            "median_branch_gap": float(np.median(widest)),
            "greedy_tokens": n}


#: the numbers a cell's limits may name; a limit is a ceiling unless the
#: name is a floor's
COMPARED = ("max_gap", "flip_share", "mean_gap", "median_branch_gap",
            "commit_mismatch", "failed", "greedy_tokens")
FLOORS = {"greedy_tokens": "min_greedy_tokens"}


def verdict(readings: Dict[str, float], limits: Dict[str, Any]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Each compared number beside its limit; ``correct`` when every one
    holds.  ``commit_mismatch`` and ``failed`` are held to 0 in every
    cell; the gap readings where the cell's limits name them."""
    lim = dict(limits, commit_mismatch=0, failed=0)
    rows = {}
    for name in COMPARED:
        key = FLOORS.get(name, name)
        if key in lim:
            rows[name] = (readings[name], lim[key], name not in FLOORS)
    ok = all(v <= cap if ceiling else v >= cap
             for v, cap, ceiling in rows.values())
    return ok, {k: {"value": v, "limit": cap}
                for k, (v, cap, _) in rows.items()}
