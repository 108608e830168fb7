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

  host.*                                        — host spans of a
     timing recorder (``HOST_SPANS``; below)
  prefill.mamba                                 — device time of a
     prefill's Mamba-2 mixers (``PREFILL_MAMBA``; below)

``track`` names the Perfetto track the event renders on: ``requests``,
``rounds``, ``planner``, ``perf``, ``host``, ``slot:<i>``, ``shard:<i>``.

Disabled cost is one branch: call sites guard on ``tracer.enabled``
before building kwargs, and ``NULL_RECORDER`` (the default everywhere)
is a permanently-disabled singleton whose ``emit`` returns immediately —
a scheduler constructed without a tracer records zero events.

**Timing** (``FlightRecorder(timing=True)``; off by default, and off the
event stream is exactly the untimed one). ``span(name)`` opens
``torch.profiler.record_function(name)``, so a running profiler holds
the span on the device trace's own clock, and on exit emits a ``host.*``
event on the ``host`` track stamped at entry from the bound clock (under
a ``WallClock`` the base of a live deployment), its wall duration in
``wall_dur_ms``. Off, ``span`` returns a shared no-op context: one call
and one attribute test. While a timing recorder is attached to a
scheduler (``attach``), ``model_range`` labels each layer's attention
and FFN or MoE and the LM head with profiler ranges (``host.layer.*``,
``host.head``); otherwise it costs one branch, and inside a CUDA-graph
replay nothing (a replay runs no Python). On a CUDA device ``attach``
records one anchor event with a single synchronise; ``device_events``
gives a CUDA event pair whose ``device_read`` (once its end event has
completed) is the pair's device ms and its start on the bound clock
(``device_ms``, ``device_t_ms``, kept in ``wall_args``): the executor
times each round with one, the stepper each prefill, and neither adds a
synchronise. Inside a prefill's forward the stepper opens
``mamba_pairs``: each Mamba-2 mixer the model enters there
(``mamba_range``) records a CUDA event pair, and the scheduler emits
their sum as one ``prefill.mamba`` event once the first token is on the
host. ``obs.export.chrome_trace`` draws the round
and prefill pairs on a ``device`` track: the gaps between them are the
device's idle time, and under a ``WallClock`` they line up with the host
spans.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Any

import torch

#: the host spans a timing recorder emits, each where its work happens:
#: the scheduler's health poll, its admissions (and each one's, from its
#: pop to its first token on the host with its row written), the
#: prefill (its state and its forward), the first token's read, the
#: row's write into the pool, the round's dispatch, the harvest's wait
#: and the parity re-encode
HOST_SPANS = frozenset({
    "host.health", "host.admit_prefill", "host.admit",
    "host.prefill", "host.prefill.state", "host.prefill.forward",
    "host.first_token", "host.write_slot",
    "host.round_dispatch", "host.harvest_wait", "host.reencode",
})

#: a prefill's Mamba-2 mixers on the device (a CUDA event pair around
#: each), summed per prefill into one event
PREFILL_MAMBA = "prefill.mamba"

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
}) | HOST_SPANS | {PREFILL_MAMBA}

_NO_SPAN = contextlib.nullcontext()
#: timing recorders attached in this process (``model_range`` is on while
#: any is)
_attached = 0
#: the open ``mamba_pairs`` collection (a list of CUDA event pairs), or
#: None (``mamba_range`` is then a no-op)
_mamba_pairs: list | None = None


def model_range(name: str):
    """``record_function(name)`` while a timing recorder is attached,
    else a shared no-op context."""
    if _attached:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def mamba_range():
    """A CUDA event pair around a Mamba-2 mixer, kept while a
    ``mamba_pairs`` collection is open; else a shared no-op context."""
    if _mamba_pairs is None:
        return _NO_SPAN
    return _event_pair(_mamba_pairs)


@contextlib.contextmanager
def _event_pair(pairs: list):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    pairs.append((start, end))


def alloc_counts(device) -> dict[str, int]:
    """The caching allocator's retries and device mallocs so far on a
    CUDA ``device`` (the latter where the installed torch reports it);
    empty elsewhere."""
    if torch.device(device).type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    out = {"cuda_alloc_retries": int(stats.get("num_alloc_retries", 0))}
    if "num_device_alloc" in stats:
        out["cuda_device_mallocs"] = int(stats["num_device_alloc"])
    return out


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

    def __init__(self, capacity: int = 65536, clock: Any = None,
                 timing: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.buf: deque[TraceEvent] = deque(maxlen=self.capacity)
        self.clock = clock
        self.n_emitted = 0
        self._epoch = time.perf_counter()
        self.timing = bool(timing)
        self._holds = 0
        # (CUDA event, its time on the bound clock): places device spans
        self._anchor: tuple[Any, float] | None = None

    # ----------------------------------------------------------- clocks ----
    def bind_clock(self, clock: Any):
        """Adopt ``clock`` as the sim-time source if none is bound yet."""
        if self.clock is None:
            self.clock = clock

    def wall_now_ms(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e3

    def now_ms(self) -> float:
        return self.clock.now() if self.clock is not None else 0.0

    # ----------------------------------------------------------- timing ----
    def attach(self, device=None):
        """A scheduler took this recorder: while timing, hold the model's
        profiler ranges on and, on a CUDA device, record the anchor (once,
        with one synchronise)."""
        global _attached
        if not self.timing:
            return
        self._holds += 1
        _attached += 1
        if self._anchor is None and device is not None \
                and torch.device(device).type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ev.synchronize()
            self._anchor = (ev, self.now_ms())

    def detach(self):
        """A scheduler let go of this recorder."""
        global _attached
        if self._holds:
            self._holds -= 1
            _attached -= 1

    def span(self, name: str, **args):
        """A host span (``HOST_SPANS``) around a ``with`` block; yields
        the span (whose ``wall_args`` the block may add to) while timing,
        else None."""
        if not self.timing:
            return _NO_SPAN
        return _Span(self, name, args)

    def device_events(self):
        """A CUDA event pair whose start is recorded now, or None (timing
        off, or no anchor: not on a card). The caller records the end."""
        if self._anchor is None:
            return None
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        return start, torch.cuda.Event(enable_timing=True)

    @contextlib.contextmanager
    def mamba_pairs(self):
        """Collect the ``mamba_range`` pairs entered inside the block
        where ``device_events`` would time (timing, on a card); yields
        the list of pairs, or None where nothing is collected."""
        global _mamba_pairs
        if self._anchor is None or _mamba_pairs is not None:
            yield None
            return
        pairs = _mamba_pairs = []
        try:
            yield pairs
        finally:
            _mamba_pairs = None

    def device_read(self, pair) -> dict:
        """``device_ms`` and ``device_t_ms`` (the start on the bound
        clock) of a pair whose end event has completed; {} for None."""
        if pair is None:
            return {}
        start, end = pair
        anchor, t_ms = self._anchor
        return {"device_ms": start.elapsed_time(end),
                "device_t_ms": t_ms + anchor.elapsed_time(start)}

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


class _Span:
    """One open host span of a timing recorder."""

    __slots__ = ("rec", "name", "args", "wall_args", "t_ms", "t0", "rf")

    def __init__(self, rec: FlightRecorder, name: str, args: dict):
        self.rec, self.name, self.args = rec, name, args
        self.wall_args: dict = {}

    def __enter__(self):
        self.t_ms = self.rec.now_ms()
        self.t0 = time.perf_counter()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        if exc[0] is None:
            wall = (time.perf_counter() - self.t0) * 1e3
            self.rec.emit(self.name, track="host", t_ms=self.t_ms,
                          dur_ms=max(self.rec.now_ms() - self.t_ms, 0.0),
                          wall_dur_ms=wall, wall_args=self.wall_args,
                          **self.args)
        return False


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
