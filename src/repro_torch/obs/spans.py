"""Request-scoped span trees: per-request latency decomposition (the
port's own copy of the reference package's host-only ``obs/spans.py``).

The flight recorder explains ROUNDS and the shard timeline
explains DEVICES, but neither answers the serving question the paper's
central claim is about: *why was request X slow, and was a fault the
cause?* This module builds one span tree per request, covering its whole
lifetime with NO gaps, so every millisecond of a request's latency is
attributed to exactly one phase:

    request (root: arrival -> terminal)
      queue_wait                       arrival -> first admission
      prefill                          prompt pass (sim-instant today;
                                       becomes a real span when chunked
                                       prefill lands — wall time is
                                       already measured and quarantined)
      decode                           one per admission episode
        decode.round                   one slice per decode round ridden,
                                       tagged with the executor round id
          stall                        the slice's straggler/fault excess
                                       over the fault-free counterfactual
                                       of the SAME latency draw
      fault_recovery                   a beyond-budget 2MR event evicted
                                       the request: requeue -> re-admission
        heal_wait                      replica swap + parity re-encode
                                       (sim-instant; wall cost quarantined)
        requeue                        time back in the admission queue

Top-level phases tile [arrival, terminal] exactly and decode slices tile
each decode span — ``RequestTree.check_closed`` enforces it, and the
Perfetto exporter re-checks the same contract on the serialised trace
(``validate_chrome_trace(require_span_closure=True)``).

Clock discipline matches ``TraceEvent``: the simulated clock is the
primary stamp (``t0_ms``/``t1_ms``), wall-clock measurements are
quarantined in ``wall_*`` fields, and ``comparable()`` projects them
away — a seeded chaos run traced twice yields bit-identical span trees.

``obs.slo`` consumes these trees: TTFT/TPOT decompositions, deadline-miss
cause attribution, Prometheus ``repro_slo_*`` counters, and the
``python -m repro_torch.obs.slo report`` CLI.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from typing import Any

#: span taxonomy (tree levels documented in the module docstring)
SPAN_ROOT = "request"
SPAN_QUEUE_WAIT = "queue_wait"
SPAN_PREFILL = "prefill"
SPAN_DECODE = "decode"
SPAN_SLICE = "decode.round"
SPAN_STALL = "stall"
SPAN_FAULT_RECOVERY = "fault_recovery"
SPAN_HEAL_WAIT = "heal_wait"
SPAN_REQUEUE = "requeue"

SPAN_NAMES = frozenset({
    SPAN_ROOT, SPAN_QUEUE_WAIT, SPAN_PREFILL, SPAN_DECODE, SPAN_SLICE,
    SPAN_STALL, SPAN_FAULT_RECOVERY, SPAN_HEAL_WAIT, SPAN_REQUEUE,
})

#: top-level phases that must tile the root span (gap accounting)
TOP_PHASES = (SPAN_QUEUE_WAIT, SPAN_PREFILL, SPAN_DECODE,
              SPAN_FAULT_RECOVERY)

#: tolerance for the tiling checks (sim ms; float accumulation only)
GAP_EPS_MS = 1e-6


class Span:
    """One node of a request span tree.

    Deterministic fields: ``name``, ``t0_ms``, ``t1_ms``, ``args``,
    ``children``. Wall-clock measurements live ONLY in ``wall_t0_ms`` /
    ``wall_t1_ms`` / ``wall_args`` and are excluded from
    ``comparable()`` — the same quarantine ``TraceEvent`` applies.
    """

    __slots__ = ("name", "t0_ms", "t1_ms", "wall_t0_ms", "wall_t1_ms",
                 "args", "wall_args", "children")

    def __init__(self, name: str, t0_ms: float, wall_t0_ms: float = 0.0,
                 args: dict | None = None, wall_args: dict | None = None):
        if name not in SPAN_NAMES:
            raise ValueError(f"unknown span name {name!r} "
                             f"(known: {sorted(SPAN_NAMES)})")
        self.name = name
        self.t0_ms = float(t0_ms)
        self.t1_ms: float | None = None
        self.wall_t0_ms = float(wall_t0_ms)
        self.wall_t1_ms: float | None = None
        self.args: dict = dict(args or {})
        self.wall_args: dict = dict(wall_args or {})
        self.children: list[Span] = []

    # ----------------------------------------------------------- state ----
    @property
    def closed(self) -> bool:
        return self.t1_ms is not None

    @property
    def dur_ms(self) -> float:
        return (self.t1_ms - self.t0_ms) if self.closed else 0.0

    def close(self, t1_ms: float, wall_t1_ms: float | None = None):
        if self.closed:
            raise RuntimeError(f"span {self.name!r} already closed")
        if t1_ms < self.t0_ms:
            raise ValueError(f"span {self.name!r} would close before it "
                             f"opened ({t1_ms} < {self.t0_ms})")
        self.t1_ms = float(t1_ms)
        self.wall_t1_ms = float(wall_t1_ms) if wall_t1_ms is not None \
            else self.wall_t0_ms
        return self

    def add(self, child: "Span") -> "Span":
        self.children.append(child)
        return child

    # ------------------------------------------------------------ read ----
    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def comparable(self) -> tuple:
        """Deterministic projection (replay-equality tests) — the same
        contract as ``TraceEvent.comparable``: no wall fields."""
        return (self.name, self.t0_ms, self.t1_ms,
                tuple(sorted(self.args.items())),
                tuple(c.comparable() for c in self.children))


class RequestTree:
    """The span tree of one request, built incrementally by the tracker
    as the scheduler drives the request through its lifecycle."""

    def __init__(self, rid: int, arrival_ms: float, wall_ms: float,
                 deadline_ms: float | None = None, priority: int = 0):
        self.rid = int(rid)
        self.deadline_ms = deadline_ms
        self.state = "open"               # open | completed | shed
        self.root = Span(SPAN_ROOT, arrival_ms, wall_ms,
                         args={"rid": self.rid, "deadline_ms": deadline_ms,
                               "priority": priority})
        self._wait: Span | None = None    # open queue_wait / fault_recovery
        self._decode: Span | None = None  # open decode episode

    # -------------------------------------------------------- accessors ----
    @property
    def arrival_ms(self) -> float:
        return self.root.t0_ms

    @property
    def finished_ms(self) -> float | None:
        return self.root.t1_ms

    def phases(self) -> list[Span]:
        return self.root.children

    def by_name(self, name: str) -> list[Span]:
        return [s for s in self.root.walk() if s.name == name]

    def comparable(self) -> tuple:
        return (self.rid, self.state, self.root.comparable())

    # ---------------------------------------------------------- contract ----
    def check_closed(self, eps: float = GAP_EPS_MS):
        """Raise ``ValueError`` unless this tree is terminal, every span is
        closed, top-level phases tile [arrival, terminal] gap-free, and
        decode slices tile their decode span. Returns self."""
        if self.state == "open":
            raise ValueError(f"request {self.rid}: tree still open")
        for s in self.root.walk():
            if not s.closed:
                raise ValueError(
                    f"request {self.rid}: span {s.name!r} never closed")
        t = self.root.t0_ms
        for phase in self.phases():
            if phase.name not in TOP_PHASES:
                raise ValueError(f"request {self.rid}: {phase.name!r} is "
                                 "not a top-level phase")
            if abs(phase.t0_ms - t) > eps:
                raise ValueError(
                    f"request {self.rid}: gap before {phase.name!r} "
                    f"({t} -> {phase.t0_ms})")
            t = phase.t1_ms
        if abs(t - self.root.t1_ms) > eps:
            raise ValueError(f"request {self.rid}: phases end at {t}, "
                             f"root at {self.root.t1_ms}")
        for dec in self.by_name(SPAN_DECODE):
            t = dec.t0_ms
            for sl in dec.children:
                if sl.name != SPAN_SLICE:
                    raise ValueError(f"request {self.rid}: {sl.name!r} "
                                     "under decode")
                if abs(sl.t0_ms - t) > eps:
                    raise ValueError(
                        f"request {self.rid}: decode slice gap "
                        f"({t} -> {sl.t0_ms})")
                t = sl.t1_ms
            if abs(t - dec.t1_ms) > eps:
                raise ValueError(
                    f"request {self.rid}: decode slices end at {t}, "
                    f"span at {dec.t1_ms}")
        return self


class SpanTracker:
    """Builds request span trees from runtime emission points.

    The scheduler owns one tracker (always on, like ``ShardTimeline``) and
    drives it from submission/admission/round/requeue/terminal hooks; the
    admission queue stamps shed reasons, the executor pool attaches
    measured per-round wall attribution, and ``ModelStepper`` supplies
    prefill / re-encode wall costs. Memory is bounded: terminal trees
    live in a ring (oldest dropped, counted), per-round wall buffers in a
    small deque.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.open: dict[int, RequestTree] = {}
        self.done: deque[RequestTree] = deque(maxlen=self.capacity)
        self.n_terminal = 0
        self._epoch = time.perf_counter()
        # measured wall attribution arrives from the executor pool a round
        # late (overlap) or a round early (sync harvest): buffer both ways
        self._slices_by_round: OrderedDict[int, list[Span]] = OrderedDict()
        self._wall_by_round: OrderedDict[int, tuple] = OrderedDict()

    # ----------------------------------------------------------- clocks ----
    def wall_now_ms(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e3

    # ------------------------------------------------------- lifecycle ----
    def on_submit(self, req) -> RequestTree:
        tree = RequestTree(req.rid, req.arrival_ms, self.wall_now_ms(),
                           deadline_ms=req.deadline_ms,
                           priority=req.priority)
        tree._wait = tree.root.add(
            Span(SPAN_QUEUE_WAIT, req.arrival_ms, self.wall_now_ms()))
        self.open[req.rid] = tree
        return tree

    def on_shed(self, req, t_ms: float, reason: str):
        """Terminal: the depth bound dropped this request (its cause is
        ``shed`` by definition — never a deadline-miss phase)."""
        tree = self.open.pop(req.rid, None)
        if tree is None:
            return
        wall = self.wall_now_ms()
        if tree._wait is not None and not tree._wait.closed:
            tree._wait.close(max(t_ms, tree._wait.t0_ms), wall)
            tree._wait = None
        tree.root.args["shed_reason"] = reason
        tree.root.close(max(t_ms, tree.root.t0_ms), wall)
        tree.state = "shed"
        self._finish(tree)

    def on_admit(self, req, t_ms: float, prefill_wall_ms: float = 0.0,
                 t1_ms: float | None = None):
        """Close the open wait span (initial queue_wait, or the requeue
        child of a fault_recovery span), stamp the prefill, and open a
        decode episode. The prefill spans ``t_ms`` to ``t1_ms``, the
        first token on the host (default ``t_ms``): on a simulated clock
        an instant (admission-time prefill does not advance it) whose
        real cost is quarantined in ``wall_args``, on a wall clock the
        admission's time."""
        tree = self.open.get(req.rid)
        if tree is None:
            return
        wall = self.wall_now_ms()
        if tree._wait is not None:
            if tree._wait.name == SPAN_FAULT_RECOVERY:
                for c in tree._wait.children:
                    if c.name == SPAN_REQUEUE and not c.closed:
                        c.close(t_ms, wall)
                tree._wait.close(t_ms, wall)
            else:
                tree._wait.close(t_ms, wall)
            tree._wait = None
        t1 = t_ms if t1_ms is None else t1_ms
        tree.root.add(Span(SPAN_PREFILL, t_ms, wall,
                           args={"n_requeues": req.n_requeues,
                                 "first_token": True},
                           wall_args={"prefill_ms": prefill_wall_ms})
                      ).close(t1, wall)
        tree._decode = tree.root.add(Span(SPAN_DECODE, t1, wall))

    def on_round(self, rid: int, t0_ms: float, dt_ms: float,
                 round_idx: int, stall_ms: float = 0.0):
        """One decode-round slice [t0, t0+dt] for an occupied slot.
        ``round_idx`` is the executor dispatch id the slice rode (the
        Perfetto flow-arrow anchor); ``stall_ms`` is the deterministic
        straggler/fault excess of this round over its fault-free
        counterfactual (same latency draw, full mask, no slowdowns)."""
        tree = self.open.get(rid)
        if tree is None or tree._decode is None:
            return
        wall = self.wall_now_ms()
        sl = tree._decode.add(Span(
            SPAN_SLICE, t0_ms, wall,
            args={"round": int(round_idx),
                  "stall_ms": round(float(stall_ms), 9)}))
        sl.close(t0_ms + dt_ms, wall)
        if stall_ms > 0:
            sl.add(Span(SPAN_STALL, t0_ms + dt_ms - stall_ms, wall)
                   ).close(t0_ms + dt_ms, wall)
        self._slices_by_round.setdefault(int(round_idx), []).append(sl)
        while len(self._slices_by_round) > 64:
            self._slices_by_round.popitem(last=False)
        pending = self._wall_by_round.get(int(round_idx))
        if pending is not None:
            sl.wall_args.update(period_ms=pending[0], block_ms=pending[1])

    def on_round_wall(self, round_idx: int, period_ms: float,
                      block_ms: float):
        """Executor-pool emission point: the MEASURED wall attribution of
        one harvested round (pipelined period + unhidden device block
        time), stamped onto every slice that rode it. Quarantined in
        ``wall_args`` — replay comparison never sees it."""
        for sl in self._slices_by_round.get(int(round_idx), ()):
            sl.wall_args.update(period_ms=float(period_ms),
                                block_ms=float(block_ms))
        self._wall_by_round[int(round_idx)] = (float(period_ms),
                                               float(block_ms))
        while len(self._wall_by_round) > 64:
            self._wall_by_round.popitem(last=False)

    def on_requeue(self, req, t_ms: float, fault: dict | None = None):
        """A beyond-budget failure evicted this request: close the decode
        episode (its work is discarded — ``wasted=True`` routes it to the
        fault_recovery bucket in the TTFT decomposition) and open a
        fault_recovery span carrying the triggering fault's identity (the
        flow-arrow anchor back to the injector erasure)."""
        tree = self.open.get(req.rid)
        if tree is None:
            return
        wall = self.wall_now_ms()
        if tree._decode is not None:
            if not tree._decode.closed:
                tree._decode.args["wasted"] = True
                tree._decode.close(t_ms, wall)
            tree._decode = None
        fr = tree.root.add(Span(
            SPAN_FAULT_RECOVERY, t_ms, wall,
            args={"n_requeues": req.n_requeues, **(fault or {})}))
        fr.add(Span(SPAN_REQUEUE, t_ms, wall))
        tree._wait = fr

    def on_heal(self, t_ms: float, reencode_wall_ms: float = 0.0):
        """Replica swap + parity re-encode finished: stamp a heal_wait
        child into every open fault_recovery span. Sim-instant (the 2MR
        swap happens within the round); the re-encode's real cost is
        quarantined in ``wall_args``."""
        wall = self.wall_now_ms()
        for tree in self.open.values():
            fr = tree._wait
            if fr is not None and fr.name == SPAN_FAULT_RECOVERY:
                fr.add(Span(SPAN_HEAL_WAIT, t_ms, wall,
                            wall_args={"reencode_ms": reencode_wall_ms})
                       ).close(t_ms, wall)

    def on_complete(self, req, t_ms: float):
        tree = self.open.pop(req.rid, None)
        if tree is None:
            return
        wall = self.wall_now_ms()
        if tree._decode is not None and not tree._decode.closed:
            tree._decode.close(t_ms, wall)
        tree._decode = None
        tree.root.args.update(n_tokens=len(req.tokens),
                              n_requeues=req.n_requeues,
                              ttft_ms=req.ttft_ms)
        tree.root.close(t_ms, wall)
        tree.state = "completed"
        self._finish(tree)

    def _finish(self, tree: RequestTree):
        self.n_terminal += 1
        self.done.append(tree)

    # ------------------------------------------------------------- read ----
    @property
    def dropped(self) -> int:
        """Terminal trees evicted by the ring bound."""
        return self.n_terminal - len(self.done)

    def trees(self) -> list[RequestTree]:
        """Terminal trees then still-open ones, rid-ordered within each."""
        return sorted(self.done, key=lambda t: t.rid) + \
            sorted(self.open.values(), key=lambda t: t.rid)

    def terminal(self) -> list[RequestTree]:
        return sorted(self.done, key=lambda t: t.rid)

    def comparable(self) -> list[tuple]:
        """Deterministic projection of every tree (replay tests)."""
        return [t.comparable() for t in self.trees()]

    def check_all_closed(self) -> int:
        """Contract check over every TERMINAL tree; returns how many
        passed (raises on the first violation)."""
        for tree in self.terminal():
            tree.check_closed()
        return len(self.done)

    def __len__(self) -> int:
        return len(self.done) + len(self.open)
