"""Runtime of the port: the single-device serving engine and the
scheduler above it; training's step builder (``runtime.train_loop``) and
``FaultTolerantTrainer`` (``runtime.fault``) are imported from their
modules."""

from repro_torch.runtime.scheduler import (
    AdmissionDenied,
    Request,
    Scheduler,
    SchedulerConfig,
)
from repro_torch.runtime.serve_loop import ServeEngine, TokenDomain

__all__ = ["AdmissionDenied", "Request", "Scheduler", "SchedulerConfig",
           "ServeEngine", "TokenDomain"]
