"""Observability of the port's runtime: the flight recorder's ring buffer
and emission API (``tracer``) and the per-shard health timeline
(``shardlog``). Export, spans and SLO reports are not ported yet."""
from repro_torch.obs.shardlog import ShardTimeline
from repro_torch.obs.tracer import (EVENT_KINDS, NULL_RECORDER,
                                    FlightRecorder, TraceEvent)

__all__ = ["EVENT_KINDS", "FlightRecorder", "NULL_RECORDER", "TraceEvent",
           "ShardTimeline"]
