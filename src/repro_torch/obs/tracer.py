"""Flight recorder: structured, dual-stamped event tracing for the runtime.

A copy of the reference package's ring buffer and emission API
(``FlightRecorder``, ``NULL_RECORDER``); ``obs.export`` writes it as a
Perfetto/Chrome trace and validates it. Every lifecycle transition becomes a
structured ``TraceEvent`` held in a bounded ring buffer, stamped with
BOTH clocks —

  * ``t_ms``     — the runtime's simulated clock (deterministic: a seeded
    chaos run traced twice produces identical event streams);
  * ``wall_ms``  — process-relative wall time (real hardware timing; by
    construction the ONLY nondeterministic fields are ``wall_ms``,
    ``wall_dur_ms`` and ``wall_args``, so replay comparison is
    ``comparable()`` equality).

Event taxonomy (``kind``, dot-namespaced):

  request.submit / request.shed / request.admit / request.first_token /
  request.complete / request.requeue            — request lifecycle
  round.dispatch / round.harvest                — executor round lifecycle
     (harvest carries the overlap attribution: the pipelined round
      period and the device-block time NOT hidden by host work)
  fault.inject / fault.recovered / fault.beyond_budget / fault.noop      —
     injected fault -> its resolution (in-step CDC recovery, 2MR
     requeue, or duplicate report)
  shard.heal / shard.heal_all / code.reencode / code.resize             —
     heal + re-encode chain, planner-driven geometry changes
  planner.plan                                  — one planner decision with
     the window stats it saw (est unavailability, window max dead, reason)
  perf.attribution / perf.counter               — roofline cost attribution
     (once per code geometry) and the per-harvest achieved-vs-roofline
     counter samples (``obs.perf``; rendered as Perfetto counter tracks)

``track`` names the Perfetto track the event renders on: ``requests``,
``rounds``, ``planner``, ``perf``, ``slot:<i>``, ``shard:<i>``.

Disabled cost is one branch: call sites guard on ``tracer.enabled``
before building kwargs, and ``NULL_RECORDER`` (the default everywhere)
is a permanently-disabled singleton whose ``emit`` returns immediately —
a scheduler constructed without a tracer records zero events.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any

#: the full event taxonomy; ``emit`` rejects unknown kinds so a typo
#: cannot create a phantom event stream (mirrors the counter registry).
EVENT_KINDS = frozenset({
    "request.submit", "request.shed", "request.admit",
    "request.first_token", "request.complete", "request.requeue",
    "round.dispatch", "round.harvest",
    "fault.inject", "fault.recovered", "fault.beyond_budget", "fault.noop",
    "shard.heal", "shard.heal_all", "code.reencode", "code.resize",
    "planner.plan",
    "perf.attribution", "perf.counter",
})


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One recorded event. ``dur_ms`` > 0 makes it a span (Perfetto "X"
    slice starting at ``t_ms``); 0 is an instant. Deterministic fields:
    everything except ``wall_ms``/``wall_dur_ms``/``wall_args``."""
    seq: int
    kind: str
    track: str
    t_ms: float                    # simulated clock stamp
    wall_ms: float                 # process-relative wall clock stamp
    dur_ms: float = 0.0            # span duration in sim time
    wall_dur_ms: float = 0.0       # span duration in wall time
    args: dict = dataclasses.field(default_factory=dict)
    wall_args: dict = dataclasses.field(default_factory=dict)

    def comparable(self) -> tuple:
        """The deterministic projection used by replay-equality tests."""
        return (self.seq, self.kind, self.track, self.t_ms, self.dur_ms,
                tuple(sorted(self.args.items())))


class FlightRecorder:
    """Bounded ring buffer of ``TraceEvent``s with dual-clock stamping.

    ``capacity`` bounds memory: once full, the OLDEST events are dropped
    (``dropped`` counts them) — the recorder never grows with run length.
    The simulated clock is bound lazily (``bind_clock``) by the first
    scheduler that uses the recorder, so ``emit`` callers without a clock
    in scope (e.g. ``ModelStepper.set_code_r``) still get sim stamps.
    """

    enabled: bool = True

    def __init__(self, capacity: int = 65536, clock: Any = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.buf: deque[TraceEvent] = deque(maxlen=self.capacity)
        self.clock = clock
        self.n_emitted = 0
        self._epoch = time.perf_counter()

    # ----------------------------------------------------------- clocks ----
    def bind_clock(self, clock: Any):
        """Adopt ``clock`` as the sim-time source if none is bound yet."""
        if self.clock is None:
            self.clock = clock

    def wall_now_ms(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e3

    # ------------------------------------------------------------ write ----
    def emit(self, kind: str, track: str = "runtime",
             t_ms: float | None = None, dur_ms: float = 0.0,
             wall_dur_ms: float = 0.0, wall_args: dict | None = None,
             **args) -> TraceEvent | None:
        """Record one event. ``t_ms=None`` stamps with the bound sim
        clock (0.0 if none). Keyword ``args`` must be JSON-serialisable
        and deterministic — wall-clock measurements go in ``wall_dur_ms``
        / ``wall_args`` so replay comparison stays exact."""
        if not self.enabled:
            return None
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown trace event kind {kind!r} "
                             f"(known: {sorted(EVENT_KINDS)})")
        if t_ms is None:
            t_ms = self.clock.now() if self.clock is not None else 0.0
        ev = TraceEvent(self.n_emitted, kind, track, float(t_ms),
                        self.wall_now_ms(), float(dur_ms),
                        float(wall_dur_ms), args, dict(wall_args or {}))
        self.n_emitted += 1
        self.buf.append(ev)
        return ev

    def clear(self):
        self.buf.clear()
        self.n_emitted = 0

    # ------------------------------------------------------------- read ----
    @property
    def dropped(self) -> int:
        """Events evicted by the ring bound since the last ``clear``."""
        return self.n_emitted - len(self.buf)

    def events(self) -> list[TraceEvent]:
        return list(self.buf)

    def by_kind(self, *kinds: str) -> list[TraceEvent]:
        want = set(kinds)
        return [e for e in self.buf if e.kind in want]

    def tracks(self) -> list[str]:
        seen: dict[str, None] = {}
        for e in self.buf:
            seen.setdefault(e.track)
        return list(seen)

    def comparable(self) -> list[tuple]:
        """Deterministic projection of the whole buffer (replay tests)."""
        return [e.comparable() for e in self.buf]

    def __len__(self) -> int:
        return len(self.buf)


class _NullRecorder(FlightRecorder):
    """Permanently disabled recorder: the default wired everywhere, so
    the un-traced hot path pays exactly one ``tracer.enabled`` branch."""

    enabled = False

    def __init__(self):
        super().__init__(capacity=1)

    def bind_clock(self, clock: Any):        # shared singleton: never bind
        pass

    def emit(self, *a, **kw) -> None:
        return None


NULL_RECORDER = _NullRecorder()
