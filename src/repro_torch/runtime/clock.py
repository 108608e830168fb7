"""Clocks for the coded cluster runtime.

All runtime timing is in **milliseconds** (matching ``core.failure``'s
latency models). The scheduler never calls ``time`` directly — it asks a
clock, so tests and benchmarks drive a deterministic ``SimClock`` while a
live deployment can plug in ``WallClock`` without touching scheduling
logic.
"""
from __future__ import annotations

import time
from typing import Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    def now(self) -> float:
        """Current time in milliseconds."""
        ...


class SimClock:
    """Deterministic simulated clock, advanced explicitly by the runtime."""

    def __init__(self, start_ms: float = 0.0):
        self._now = float(start_ms)

    def now(self) -> float:
        return self._now

    def advance(self, dt_ms: float) -> float:
        if dt_ms < 0:
            raise ValueError(f"cannot advance clock by {dt_ms} ms")
        self._now += float(dt_ms)
        return self._now

    def advance_to(self, t_ms: float) -> float:
        """Jump forward to ``t_ms`` (no-op if already past it)."""
        self._now = max(self._now, float(t_ms))
        return self._now


class WallClock:
    """Monotonic wall time in ms (for live serving, not used by tests)."""

    def __init__(self):
        self._t0 = time.monotonic()

    def now(self) -> float:
        return (time.monotonic() - self._t0) * 1e3
