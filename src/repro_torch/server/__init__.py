"""repro_torch.server — the multi-tenant async serving front door.

The port's copy of the JAX package's ``repro.server``, stdlib asyncio over
the port's engine.  HTTP/SSE over a
:class:`~repro_torch.api.BranchSession`: one background
engine loop folds every tenant's branches into one continuous batch
(:mod:`~repro_torch.server.multiplex`), per-tenant quotas and priority-based
preemption layer policy on the scheduler's reservation ledger
(:mod:`~repro_torch.server.tenancy`), and a zero-dependency asyncio HTTP/1.1
app exposes generate/explore/tree/metrics (:mod:`~repro_torch.server.app`).
See DESIGN.md §14.
"""

from repro_torch.server.app import POLICIES, FrontDoor, Response
from repro_torch.server.client import ServeClient, ServeError
from repro_torch.server.multiplex import EngineLoop, Registry, chat_policy
from repro_torch.server.tenancy import (QuotaExceeded, ServedRequest,
                                  TenancyManager, TenantConfig)

__all__ = [
    "EngineLoop",
    "FrontDoor",
    "POLICIES",
    "QuotaExceeded",
    "Registry",
    "Response",
    "ServeClient",
    "ServeError",
    "ServedRequest",
    "TenancyManager",
    "TenantConfig",
    "chat_policy",
]
