"""Serving runtime of the port: the single-device engine and the
scheduler above it."""

from repro_torch.runtime.scheduler import (
    AdmissionDenied,
    Request,
    Scheduler,
    SchedulerConfig,
)
from repro_torch.runtime.serve_loop import ServeEngine, TokenDomain

__all__ = ["AdmissionDenied", "Request", "Scheduler", "SchedulerConfig",
           "ServeEngine", "TokenDomain"]
