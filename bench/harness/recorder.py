"""The port's own spans (``repro_torch.obs.tracer``), read by the metrics
that take their numbers from inside the program: a timing flight recorder
(``FlightRecorder(timing=True)``) attached to the run's scheduler through
``ContinuousBatchingScheduler.attach_tracer``, and readers of its events
that began in the window (``t_ms``, on the run's wall clock).

Only a metric's ``install`` attaches it, and only traced runs install
per-layer metrics, so the runs that give the end-to-end metrics trace
nothing. A port without the timing recorder gets none attached, and every
reader returns None there.
"""
from __future__ import annotations

from harness import stats


def install(run):
    """Attach one timing recorder to ``run.sched`` (idempotent)."""
    if "recorder" in vars(run):
        return
    run.recorder = None
    from repro_torch.obs import tracer
    attach = getattr(run.sched, "attach_tracer", None)
    if attach is None or not hasattr(tracer, "HOST_SPANS"):
        return
    run.recorder = tracer.FlightRecorder(timing=True)
    attach(run.recorder)


def in_window(run, kind: str) -> list:
    """The recorder's ``kind`` events that began inside the window."""
    rec = vars(run).get("recorder")
    if rec is None:
        return []
    w0, w1 = run.window
    return [e for e in rec.by_kind(kind) if w0 < e.t_ms <= w1]


def wall_ms_median(run, kind: str):
    """Median wall ms of the ``kind`` spans in the window."""
    return stats.median([e.wall_dur_ms for e in in_window(run, kind)])


def device_ms(run, kind: str) -> list[float]:
    """The device ms the ``kind`` events in the window carry."""
    return [e.wall_args["device_ms"] for e in in_window(run, kind)
            if "device_ms" in e.wall_args]
