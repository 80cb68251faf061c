"""Runtime of the port: training's step builder and fault-tolerant
trainer, the serving engine and the scheduler above it."""

from repro_torch.runtime.train_loop import TrainState, build_train_step
from repro_torch.runtime.fault import FaultTolerantTrainer
from repro_torch.runtime.serve_loop import ServeEngine, TokenDomain
from repro_torch.runtime.scheduler import (
    AdmissionDenied,
    Request,
    Scheduler,
    SchedulerConfig,
)

__all__ = ["TrainState", "build_train_step", "FaultTolerantTrainer",
           "ServeEngine", "TokenDomain",
           "AdmissionDenied", "Request", "Scheduler", "SchedulerConfig"]
