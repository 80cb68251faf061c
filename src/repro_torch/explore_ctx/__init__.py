"""BranchContext — the exploration-policy subsystem (paper artifact #2).

A context-manager API (:class:`BranchContext`) over the scheduler's
admission-checked branch lifecycle, an event-driven
:class:`ExplorationDriver` that multiplexes many concurrent searches
over one engine's continuous-batching loop, and a library of reusable
policies: :func:`best_of_n`, :func:`beam_search`, :func:`tree_search`,
:func:`speculative_decode`, and the training-side
:class:`SpeculativeTrainer`.  See DESIGN §9.  The port's copy of
``repro.explore_ctx``.
"""

from repro_torch.explore_ctx.context import BranchContext, PolicyResult
from repro_torch.explore_ctx.driver import (
    Decode,
    Exploration,
    ExplorationDriver,
    Fork,
    Submit,
    Tick,
)
from repro_torch.explore_ctx.policies import (
    beam_search,
    best_of_n,
    tree_search,
)
from repro_torch.explore_ctx.scoring import (
    combined_score,
    diversity_score,
    lcp_len,
    mean_token_score,
)
from repro_torch.explore_ctx.speculative import (
    SpeculativeTrainer,
    speculative_decode,
)

__all__ = [
    "BranchContext",
    "Decode",
    "Exploration",
    "ExplorationDriver",
    "Fork",
    "PolicyResult",
    "SpeculativeTrainer",
    "Submit",
    "Tick",
    "beam_search",
    "best_of_n",
    "combined_score",
    "diversity_score",
    "lcp_len",
    "mean_token_score",
    "speculative_decode",
    "tree_search",
]
