"""Speculative exploration — drafts verified against a target.

The port's copy of ``speculative_decode`` from
``repro/explore_ctx/speculative.py``, the serving policy: N sampled
**draft** branches decode ``k`` tokens each; then ONE fused ``verify``
dispatch against the frozen origin (``ServeEngine.spec_verify``, the
paged chunk attention kernel at t = k) teacher-forces every draft row
through the target in a single pass, yielding the target's greedy token
at every draft position.  The winning draft is truncated to its verified
prefix and committed (KV pages + token tail shrink together); when
nothing verified, a held fallback branch takes one true greedy step and
commits, so the policy always makes progress.  In a deployment the
drafts come from a cheaper model; here both share the engine, so the
policy demonstrates the lifecycle + the one-dispatch verify, not an
end-to-end speedup.

The JAX package's training face, ``SpeculativeTrainer``, belongs to the
training slice and is not ported yet (ROADMAP).
"""

from __future__ import annotations

from typing import Generator

from repro_torch.api.flags import BR_SPECULATIVE
from repro_torch.core.errors import BranchError
from repro_torch.explore_ctx.context import BranchContext, policy_result
from repro_torch.explore_ctx.driver import Decode, Fork
from repro_torch.explore_ctx.scoring import lcp_len


def speculative_decode(ctx: BranchContext, *, n_drafts: int = 3,
                       draft_tokens: int = 8,
                       temperature: float = 1.5) -> Generator:
    """Draft / fused-verify / commit-the-longest-verified-prefix.

    The fork declares its children ``BR_SPECULATIVE`` — the flag that
    licenses ``truncate`` (rewriting a draft down to its verified
    prefix); an undeclared branch attempting the same gets ``-EPERM``.

    The verify phase is ONE device dispatch: ``ctx.verify`` scores all
    draft rows against the frozen origin in a single fused pass
    (``ServeEngine.spec_verify``), instead of a verifier branch decoding
    ``draft_tokens`` sequential greedy steps.  Child 0 of the fork group
    is a parked **fallback** branch that only decodes (one true greedy
    step, then commits) when every draft diverges at its first token.
    """
    try:
        kids = yield Fork(ctx, n_drafts + 1, flags=BR_SPECULATIVE)
    except BranchError:   # includes AdmissionDenied
        # permanent page pressure (or a root resolved underneath us):
        # plain greedy decode, no speculation
        yield Decode([ctx], draft_tokens, greedy=True)
        return policy_result(ctx, committed=False,
                             policy="speculative_decode", degraded=True,
                             drafts=0, accepted=0)
    fallback_br, drafts = kids[0], list(kids[1:])
    # ONE wait, one continuous batch of sampled draft lanes — no greedy
    # verifier lane decodes alongside them anymore
    yield Decode(drafts, draft_tokens, greedy=False,
                 temperature=temperature)
    rows = [d.generated() for d in drafts]
    # a draft may stop short of draft_tokens (decode budget); the fused
    # verify wants equal-length rows, so score the common length
    t = min(len(r) for r in rows)
    if t > 0:
        target_rows = ctx.verify([r[:t] for r in rows])   # ONE dispatch
        verified = [lcp_len(r[:t], tr) for r, tr in zip(rows, target_rows)]
    else:
        verified = [0] * len(drafts)
    best = max(range(len(drafts)), key=lambda i: verified[i])
    accepted = verified[best]
    # acceptance telemetry on the engine's obs hub: proposed counts every
    # draft position scored by the fused verify, accepted only the
    # winning draft's verified prefix (a fallback round is an honest 0)
    m = ctx.session.obs.metrics
    prop = m.counter("spec.tokens_proposed")
    acc = m.counter("spec.tokens_accepted")
    m.counter("spec.rounds").inc()
    prop.inc(t * len(drafts))
    acc.inc(accepted)
    m.gauge("spec.acceptance_rate").set(
        round(acc.value / max(prop.value, 1), 4))
    fallback = accepted == 0
    if fallback:
        # every draft diverged at its first token: the parked fallback
        # branch takes one true greedy step so the commit makes progress
        yield Decode([fallback_br], 1, greedy=True)
        winner = fallback_br
    else:
        winner = drafts[best]
        if accepted < len(winner.generated()):
            winner.truncate(accepted)    # keep only the verified prefix
    winner.commit()
    # 'accepted' counts only draft tokens that verified — a fallback
    # commit is an honest 0% acceptance, not a perfect run
    return policy_result(
        ctx, score=float(accepted),
        policy="speculative_decode", drafts=n_drafts,
        draft_tokens=draft_tokens, accepted=accepted, fallback=fallback,
        verified_per_draft=verified, verify_dispatches=1 if t else 0,
        acceptance_rate=accepted / max(draft_tokens, 1))


__all__ = ["speculative_decode"]
