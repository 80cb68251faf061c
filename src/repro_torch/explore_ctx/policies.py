"""Ready-to-use exploration policies (the paper's BranchContext library).

Each policy is a generator over one exploration root: it yields work
items (:class:`~repro_torch.explore_ctx.driver.Fork`,
:class:`~repro_torch.explore_ctx.driver.Decode`) to the driver, resolves its
branches with ``commit``/``abort`` directly, and returns a
:class:`~repro_torch.explore_ctx.context.PolicyResult`.  Compose them with
``yield from`` (e.g. a tree search whose leaf evaluation is a nested
best-of-N), or hand them to :meth:`ExplorationDriver.explore` for the
three-line usage::

    drv = ExplorationDriver(Scheduler(engine))
    exp = drv.explore(prompt, max_new_tokens=24, policy=best_of_n, n=4)
    print(exp.run().tokens)

All branching goes through scheduler admission: under memory pressure a
policy sees backpressure (its forks wait) or, on a proven permanent
stall, ``AdmissionDenied`` — which ``tree_search`` absorbs by
committing the best of what it already has.
"""

from __future__ import annotations

from typing import Generator, List

from repro_torch.core.errors import BranchError
from repro_torch.explore_ctx.context import BranchContext
from repro_torch.explore_ctx.context import policy_result as _result
from repro_torch.explore_ctx.driver import Decode, Fork
from repro_torch.explore_ctx.scoring import Scorer, mean_token_score


def _fork_or_none(ctx: BranchContext, n: int) -> Generator:
    """Fork through admission; ``None`` when the fork cannot happen.

    Transient pressure never reaches the policy (the driver retries the
    fork as other explorations recycle pages); what lands here is the
    *permanent* -EAGAIN (the driver proved nothing else can free pages)
    or a context that resolved underneath us (e.g. the root retired at
    its budget after a degraded level) — in both cases the policy should
    degrade rather than die.
    """
    try:
        return (yield Fork(ctx, n))
    except BranchError:   # includes AdmissionDenied
        return None


def best_of_n(ctx: BranchContext, *, n: int = 4, tokens: int = 8,
              score_fn: Scorer = mean_token_score,
              temperature: float = 1.5) -> Generator:
    """Fork ``n`` branches, decode ``tokens`` each, commit the best."""
    kids = yield from _fork_or_none(ctx, n)
    if kids is None:
        # permanent page pressure: degrade to the unforked origin
        yield Decode([ctx], tokens, temperature=temperature)
        return _result(ctx, committed=False, policy="best_of_n",
                       degraded=True, branches=0, scores=[])
    yield Decode(kids, tokens, temperature=temperature)
    for k in kids:
        k.score = score_fn(k)
    winner = max(kids, key=lambda k: k.score)
    winner.commit()   # first-commit-wins recycles every sibling
    return _result(ctx, score=winner.score, policy="best_of_n",
                   branches=n, scores=[k.score for k in kids])


def beam_search(ctx: BranchContext, *, width: int = 3, depth: int = 2,
                tokens_per_level: int = 4,
                score_fn: Scorer = mean_token_score,
                temperature: float = 1.5) -> Generator:
    """Greedy beam: per level, fork ``width`` candidates and commit the
    best into the root before descending — the Tree-of-Thoughts loop of
    ``examples/agentic_serve.py`` as a reusable policy."""
    levels = []
    last_score = None
    for level in range(depth):
        kids = yield from _fork_or_none(ctx, width)
        if kids is None:
            # degrade this level to an unforked continuation
            yield Decode([ctx], tokens_per_level, temperature=temperature)
            levels.append({"level": level, "degraded": True})
            continue
        yield Decode(kids, tokens_per_level, temperature=temperature)
        for k in kids:
            k.score = score_fn(k)
        winner = max(kids, key=lambda k: k.score)
        winner.commit()   # per-level commit: losers recycled immediately
        last_score = winner.score
        levels.append({"level": level, "winner_seq": winner.seq,
                       "scores": [k.score for k in kids]})
    return _result(ctx, score=last_score, policy="beam_search",
                   width=width, depth=depth, levels=levels)


def tree_search(ctx: BranchContext, *, fan_out: int = 3,
                tokens_per_node: int = 4, max_nodes: int = 9,
                max_depth: int = 3, prune_below: float = None,
                score_fn: Scorer = mean_token_score,
                temperature: float = 1.5) -> Generator:
    """Best-first tree search with a fan-out budget and early abort.

    Expands the most promising live node into ``fan_out`` *nested*
    children until ``max_nodes`` branches have been created (or the
    page budget pushes back permanently), aborting children scoring
    below ``prune_below`` on the spot.  The best surviving node's whole
    lineage then commits level by level — recursive sibling
    invalidation reclaims every other subtree in one cascade.
    """
    frontier: List[BranchContext] = [ctx]
    candidates: List[BranchContext] = []
    created = pruned = 0
    denied = False
    while frontier and created < max_nodes:
        frontier.sort(key=lambda c: c.score if c.score is not None
                      else float("inf"), reverse=True)
        node = frontier.pop(0)
        n = min(fan_out, max_nodes - created)
        try:
            kids = yield Fork(node, n)
        except BranchError:   # includes the permanent -EAGAIN
            denied = True     # backpressure: use what we have
            break
        created += len(kids)
        yield Decode(kids, tokens_per_node, temperature=temperature)
        for k in kids:
            k.score = score_fn(k)
            if prune_below is not None and k.score < prune_below:
                k.abort()   # early abort: pages recycled mid-search
                pruned += 1
                continue
            candidates.append(k)
            if k.depth - ctx.depth < max_depth:
                frontier.append(k)
    live = [c for c in candidates if c.alive]
    if not live:
        if denied and not created:
            # couldn't even open the search: degrade to unforked decode
            yield Decode([ctx], tokens_per_node, temperature=temperature)
        # everything pruned/denied: the origin resumes — keep it
        return _result(ctx, committed=False, policy="tree_search",
                       branches_created=created, pruned=pruned,
                       denied=denied)
    best = max(live, key=lambda c: c.score)
    best.prune_children()   # an expanded winner sheds its live subtree
    best.commit_chain(until=ctx)
    return _result(ctx, score=best.score, policy="tree_search",
                   branches_created=created, pruned=pruned,
                   denied=denied, winner_depth=best.depth - ctx.depth)


__all__ = ["beam_search", "best_of_n", "tree_search"]
