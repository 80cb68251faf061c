"""Speculative exploration — drafts verified against a target.

The port's copy of ``repro/explore_ctx/speculative.py``; two faces of the
same fork/explore/commit pattern.

:func:`speculative_decode` is the serving policy: N sampled
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

:class:`SpeculativeTrainer` is the training face: every step forks K
candidate update branches inside one vmapped program (a stacked leading
axis), runs them in parallel, and first-commit-wins selects the update
with the best validation loss.
"""

from __future__ import annotations

from typing import Any, Dict, Generator, Tuple, Union

import torch
import torch.utils._pytree as pytree

from repro_torch.api.flags import BR_SPECULATIVE
from repro_torch.core.errors import BranchError
from repro_torch.core.explore import ExploreResult, explore, uniform
from repro_torch.explore_ctx.context import BranchContext, policy_result
from repro_torch.explore_ctx.driver import Decode, Fork
from repro_torch.explore_ctx.scoring import lcp_len
from repro_torch.optim import apply_updates


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


class SpeculativeTrainer:
    """Fork-K-updates/commit-best training, packaged.

    ``step`` runs one fork/explore/commit round with no host sync before
    its ``info`` is built: each branch takes ``torch.func.grad`` of the
    loss (inside ``torch.func.vmap`` over the branches, so the flash
    attention and SSD scan kernels run through their vmap rules), scales
    the gradient by a learning-rate multiplier drawn from its branch key
    (``lr_scale_base * 2**i``, ``i`` uniform in ``[0, lr_scale_steps)``),
    and applies the optimizer; success is a finite validation loss, and
    the branch with the earliest commit time (here: the lowest validation
    loss) wins.  If every branch diverges the frozen origin resumes
    unchanged — the paper's "if all branches abort, the parent resumes".
    """

    def __init__(self, model: Any, opt: Any, *, n_branches: int = 4,
                 lr_scale_base: float = 0.25, lr_scale_steps: int = 4):
        if model.plan.is_distributed:
            raise NotImplementedError(
                "SpeculativeTrainer vmaps its branches on one device, as "
                "the JAX package's does; a model over a mesh trains through "
                "build_train_step")
        self.model = model
        self.opt = opt
        self.n_branches = n_branches

        def one_branch(state, key, batch, val_batch):
            i = torch.floor(uniform(key) * lr_scale_steps)
            lr_scale = lr_scale_base * torch.pow(2.0, i)

            def loss_fn(p):
                return model.loss(p, batch)[0]

            grads = torch.func.grad(loss_fn)(state["params"])
            grads = pytree.tree_map(lambda g: g * lr_scale, grads)
            updates, new_opt = opt.update(grads, state["opt"],
                                          state["params"])
            new_params = apply_updates(state["params"], updates)
            val = model.loss(new_params, val_batch)[0]
            return ({"params": new_params, "opt": new_opt},
                    torch.isfinite(val), val)

        self._one_branch = one_branch

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        params = self.model.init(generator)
        return {"params": params, "opt": self.opt.init(params)}

    def round(self, state: Dict[str, Any],
              generator: Union[torch.Generator, int, torch.Tensor],
              batch: Any, val_batch: Any) -> ExploreResult:
        """The round on the device, nothing brought to the host."""
        return explore(
            lambda s, k: self._one_branch(s, k, batch, val_batch),
            state, self.n_branches, generator, commit_time_fn=lambda a: a)

    def step(self, state: Dict[str, Any],
             generator: Union[torch.Generator, int, torch.Tensor],
             batch: Any, val_batch: Any
             ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        res = self.round(state, generator, batch, val_batch)
        info = {"winner": int(res.winner),
                "committed": bool(res.committed),
                "val_losses": [float(v) for v in res.aux]}
        return res.state, info


__all__ = ["SpeculativeTrainer", "speculative_decode"]
