"""Coded cluster runtime of the port: continuous batching + shard health +
telemetry, driving the port's stepper and batched slot executor."""
from repro_torch.runtime.clock import Clock, SimClock, WallClock
from repro_torch.runtime.executor import SlotPoolExecutor, VStep
from repro_torch.runtime.health import (EventKind, HealthAction, ShardEvent,
                                        ShardHealthController, erasure,
                                        recovery, replica_failure)
from repro_torch.runtime.metrics import RuntimeMetrics
from repro_torch.runtime.queue import AdmissionQueue
from repro_torch.runtime.request import Request, RequestState
from repro_torch.runtime.scheduler import (ContinuousBatchingScheduler,
                                           RuntimeConfig, run_arrivals)

__all__ = [
    "Clock", "SimClock", "WallClock",
    "EventKind", "HealthAction", "ShardEvent", "ShardHealthController",
    "erasure", "recovery", "replica_failure",
    "RuntimeMetrics", "AdmissionQueue",
    "Request", "RequestState",
    "SlotPoolExecutor", "VStep",
    "ContinuousBatchingScheduler", "RuntimeConfig", "run_arrivals",
]
