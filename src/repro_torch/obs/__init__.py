"""Observability of the port's runtime, as the reference package has it:

  * ``tracer`` — the flight recorder's ring buffer and emission API;
  * ``shardlog`` — the per-shard health timeline;
  * ``export`` — Perfetto/Chrome trace export and validation, Prometheus
    text, the live ``/metrics`` server;
  * ``perf`` — per-round cost attribution (counted on torch, with the
    kernels' ``KERNEL_COSTS``) against one H100's roofline, and the
    achieved-vs-roofline utilization of the measured rounds;
  * ``history`` — schema-versioned benchmark-trajectory snapshots
    (``BENCH_history.jsonl``, the reference's schema: either package reads
    the other's file) with a direction-aware regression gate and the
    ``python -m repro_torch.obs.history {append,check}`` CLI;
  * ``spans`` — per-request span trees;
  * ``slo`` — TTFT/TPOT decompositions, deadline-miss attribution and the
    ``python -m repro_torch.obs.slo report`` CLI.
"""
from repro_torch.obs.export import (MetricsServer, chrome_trace,
                                    prometheus_text, validate_chrome_trace,
                                    write_chrome_trace)
from repro_torch.obs.history import (DEFAULT_TOLERANCES, append_snapshot,
                                     check_history, compare, load_history,
                                     make_snapshot)
from repro_torch.obs.perf import (PerfMonitor, RoundCost,
                                  attribute_round_costs)
from repro_torch.obs.shardlog import ShardTimeline
from repro_torch.obs.slo import CAUSES, attribute, decompose, summarize
from repro_torch.obs.spans import SPAN_NAMES, RequestTree, Span, SpanTracker
from repro_torch.obs.tracer import (EVENT_KINDS, NULL_RECORDER,
                                    FlightRecorder, TraceEvent)

__all__ = [
    "EVENT_KINDS", "FlightRecorder", "NULL_RECORDER", "TraceEvent",
    "ShardTimeline",
    "MetricsServer", "chrome_trace", "prometheus_text",
    "validate_chrome_trace", "write_chrome_trace",
    "PerfMonitor", "RoundCost", "attribute_round_costs",
    "DEFAULT_TOLERANCES", "append_snapshot", "check_history", "compare",
    "load_history", "make_snapshot",
    "SPAN_NAMES", "Span", "RequestTree", "SpanTracker",
    "CAUSES", "attribute", "decompose", "summarize",
]
