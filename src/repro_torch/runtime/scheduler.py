"""Continuous-batching scheduler over a fixed pool of decode slots.

A copy of the reference package's scheduler, driving the port's stepper
and slot-pool executor. It turns the paper's per-request fault-tolerance
claims ("never loses a request", close-to-zero recovery) into
steady-state properties of a request STREAM:

  * a deadline-aware admission queue (FIFO when no deadlines/priorities
    are set) feeds ``n_slots`` decode slots; a slot (its KV-cache row) is
    reused by the next queued request the moment its occupant finishes —
    continuous batching. A queue-depth bound sheds the worst-ordered
    request instead of queueing without bound;
  * every decode round consults the ``ShardHealthController``: within the
    erasure budget the round proceeds with the flipped validity mask and
    the coded GEMMs rebuild the lost shard in-step (CDC half of the §6.3
    hybrid); beyond budget, in-flight requests are requeued, the standby
    replica is swapped in, and parity is re-encoded offline (2MR half);
  * time comes from an injected clock: a deterministic ``SimClock``
    advanced by a fixed step, a straggler-model draw or an injected
    latency process. The measured wall time of every real round is
    recorded beside it (``RuntimeMetrics.round_ms``).

Execution: by default the pool lives in a ``SlotPoolExecutor`` (one round
dispatch for all slots, optional host/device overlap); ``batched=False``
keeps sequential per-slot stepping over batch-1 states as the
differential-test oracle. Every slot's tokens are host ints.

Observability as in the reference: per-request span trees (``spans``,
on by default), roofline perf accounting (``perf``) and per-round
profiler annotations (``profile``). Not ported yet: encoder extras (the
port serves decoder-only models).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any

import numpy as np

from repro_torch.core.failure import StragglerModel, request_latency
from repro_torch.core.seeds import stream_rng
from repro_torch.obs.shardlog import ShardTimeline
from repro_torch.obs.tracer import NULL_RECORDER, FlightRecorder
from repro_torch.runtime.clock import Clock, SimClock
from repro_torch.runtime.executor import SlotPoolExecutor, request_batch
from repro_torch.runtime.health import HealthAction, ShardHealthController
from repro_torch.runtime.metrics import RuntimeMetrics
from repro_torch.runtime.queue import AdmissionQueue
from repro_torch.runtime.request import Request, RequestState
from repro_torch.serve.engine import ModelStepper


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    n_slots: int = 4
    step_time_ms: float = 1.0        # fixed per-round latency (SimClock)
    straggler: StragglerModel | None = None  # sample round latency instead
    seed: int = 0
    max_requeues: int = 8            # liveness guard for event storms
    max_rounds: int = 100_000
    batched: bool = True             # False: sequential per-slot oracle
    overlap: bool = True             # pipeline host work with device rounds
    use_fused: bool | str = "auto"   # fused coded-GEMM + fused-head round
    max_queue_depth: int | None = None   # shed beyond this depth
    perf: bool = False               # roofline attribution + achieved rates
    profile: bool = False            # torch.profiler annotations per round
    spans: bool = True               # per-request span trees (obs.spans);
    #                                  bounded memory, on by default like
    #                                  the shard timeline

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {self.n_slots}")
        if self.step_time_ms < 0:
            raise ValueError("step_time_ms must be >= 0")
        if self.max_requeues < 0 or self.max_rounds < 1:
            raise ValueError("max_requeues/max_rounds out of range")
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")


@dataclasses.dataclass
class _Slot:
    idx: int
    request: Request | None = None
    state: Any = None                # sequential path: batch-1 decode state
    last_tok: Any = None
    occupancies: int = 0

    @property
    def free(self) -> bool:
        return self.request is None


class ContinuousBatchingScheduler:
    def __init__(self, stepper: ModelStepper, rcfg: RuntimeConfig,
                 clock: Clock | None = None,
                 health: ShardHealthController | None = None,
                 metrics: RuntimeMetrics | None = None,
                 latency: Any = None,
                 tracer: FlightRecorder | None = None):
        self.stepper = stepper
        self.rcfg = rcfg
        self.clock = clock if clock is not None else SimClock()
        self.health = health if health is not None else ShardHealthController(
            stepper.n_shards, stepper.erasure_budget)
        self.metrics = metrics if metrics is not None else RuntimeMetrics()
        self.tracer = tracer if tracer is not None else NULL_RECORDER
        self.tracer.bind_clock(self.clock)
        if self.tracer.enabled and not stepper.tracer.enabled:
            # adopt the stepper so code.resize lands in this stream too
            stepper.tracer = self.tracer
        # per-shard health timeline: always on (O(1) per health event)
        self.shardlog = ShardTimeline(stepper.n_shards,
                                      t0_ms=self.clock.now())
        self.health.observers.append(self.shardlog)
        # per-request span trees (obs.spans): queue_wait -> prefill ->
        # decode (per-round slices + stall) -> fault_recovery, gap-free
        # over every request lifetime (bounded ring, SimClock stamps)
        self.spans = None
        if rcfg.spans:
            from repro_torch.obs.spans import SpanTracker
            self.spans = SpanTracker()
        self.queue = AdmissionQueue(max_depth=rcfg.max_queue_depth,
                                    spans=self.spans, clock=self.clock)
        self.slots = [_Slot(i) for i in range(rcfg.n_slots)]
        self.completed: list[Request] = []
        self.shed: list[Request] = []
        # rcfg.seed is the run's ROOT seed: every stochastic component
        # (modelled stragglers here, the fault injector, the injected
        # latency process) derives an independent stream from it
        self._rng = stream_rng(rcfg.seed, "straggler")
        self._next_rid = 0
        # faults.InjectedLatency (or anything with .round_ms): replaces the
        # plain StragglerModel draw for the simulated clock advance
        self.latency = latency
        # per-round hook point: fn(scheduler) runs at the top of every
        # round, before health events apply (chaos injector, planner)
        self.round_hooks: list[Any] = []
        self.executor: SlotPoolExecutor | None = None
        if rcfg.batched:
            perf = None
            if rcfg.perf:
                # roofline-anchored round attribution: costed at first
                # harvest, achieved rates + counter-track events per round
                from repro_torch.obs.perf import PerfMonitor
                perf = PerfMonitor(metrics=self.metrics, tracer=self.tracer)
            self.executor = SlotPoolExecutor(
                stepper, rcfg.n_slots, overlap=rcfg.overlap,
                use_fused=rcfg.use_fused, metrics=self.metrics,
                tracer=self.tracer, perf=perf, profile=rcfg.profile,
                spans=self.spans)

    # --------------------------------------------------------- ingestion ----
    def submit(self, prompt, max_new_tokens: int,
               arrival_ms: float | None = None,
               deadline_ms: float | None = None,
               priority: int = 0) -> Request:
        """Enqueue a request. ``arrival_ms`` records the true arrival
        instant when submission happens at the next round boundary; it
        must not lie in the future. ``deadline_ms``/``priority`` bend the
        admission order; a full queue sheds the worst-ordered request."""
        now = self.clock.now()
        arrival = now if arrival_ms is None else min(float(arrival_ms), now)
        req = Request(self._next_rid, np.asarray(prompt, np.int32),
                      int(max_new_tokens), arrival_ms=arrival,
                      deadline_ms=deadline_ms, priority=priority)
        self._next_rid += 1
        self.metrics.count("requests_submitted")
        if self.tracer.enabled:
            self.tracer.emit("request.submit", track="requests", t_ms=now,
                             rid=req.rid, prompt_len=int(req.prompt.size),
                             max_new_tokens=req.max_new_tokens,
                             deadline_ms=deadline_ms, priority=priority)
        if self.spans is not None:
            # before push: if the depth bound sheds req itself the queue
            # terminates a tree that must already exist
            self.spans.on_submit(req)
        victim = self.queue.push(req)
        if victim is not None:
            victim.state = RequestState.SHED
            self.shed.append(victim)
            self.metrics.count_shed(victim.shed_reason or "queue_full")
            if self.tracer.enabled:
                self.tracer.emit("request.shed", track="requests",
                                 rid=victim.rid, shed_by=req.rid,
                                 reason=victim.shed_reason,
                                 queue_depth=len(self.queue))
        self.metrics.sample_queue_depth(self.clock.now(), len(self.queue))
        return req

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(not s.free for s in self.slots)

    @property
    def n_running(self) -> int:
        return sum(not s.free for s in self.slots)

    # ------------------------------------------------------------ health ----
    def _handle_health(self):
        traced = self.tracer.enabled
        for ev, action in self.health.poll_events(self.clock.now()):
            track = f"shard:{ev.shard}" if ev.shard >= 0 else "rounds"
            if action is HealthAction.CONTINUE:
                # CDC path: mask flipped, decode recovers in-step.
                self.metrics.count("erasures_recovered")
                if traced:
                    self.tracer.emit("fault.recovered", track=track,
                                     t_ms=ev.time_ms, shard=ev.shard,
                                     n_dead=self.health.n_dead,
                                     budget=self.health.budget)
            elif action is HealthAction.REQUEUE:
                if traced:
                    self.tracer.emit("fault.beyond_budget", track=track,
                                     t_ms=ev.time_ms, shard=ev.shard,
                                     fault=ev.kind.value,
                                     n_dead=self.health.n_dead,
                                     budget=self.health.budget)
                self._requeue_inflight(ev)
            elif action is HealthAction.REENCODE:
                # a shard rejoined: fold it back into the code.
                self.metrics.count("shards_healed")
                if traced:
                    self.tracer.emit("shard.heal", track=track,
                                     t_ms=ev.time_ms, shard=ev.shard,
                                     cause="recovery")
                self._reencode()
            elif traced:
                # duplicate report: resolve the injected fault explicitly
                self.tracer.emit("fault.noop", track=track,
                                 t_ms=ev.time_ms, shard=ev.shard,
                                 fault=ev.kind.value)

    def _reencode(self):
        """Offline parity re-encode + its telemetry (single emit point)."""
        self.stepper.reencode()
        self.metrics.count("parity_reencodes")
        self.shardlog.on_reencode(self.clock.now())
        if self.tracer.enabled:
            self.tracer.emit("code.reencode", track="rounds",
                             r=int(self.stepper.model.ctx.code_r)
                             if self.stepper.coded else 0,
                             wall_dur_ms=self.stepper.last_reencode_wall_ms)
        if self.spans is not None:
            # heal_wait child on every open fault_recovery span (no-op on
            # shard-rejoin re-encodes with nothing requeued)
            self.spans.on_heal(
                self.clock.now(),
                reencode_wall_ms=self.stepper.last_reencode_wall_ms)

    def _requeue_inflight(self, ev=None):
        """2MR fallback: drain slots, swap the standby replica in, re-encode
        parity. Requests keep their original arrival order; shedding never
        applies to in-flight work. ``ev`` is the beyond-budget health event
        that triggered the fallback: span trees carry its identity so the
        trace exporter can draw the fault_recovery -> injector erasure
        flow arrow."""
        self.metrics.count("beyond_budget_failures")
        fault = None
        if ev is not None:
            fault = {"fault_shard": int(ev.shard),
                     "fault_t_ms": float(ev.time_ms),
                     "fault_kind": ev.kind.value}
        if self.executor is not None:
            # in-flight round (if any) was computed for requeued occupants
            self.executor.drop_pending()
            self.executor.evict_all()
        victims = []
        for slot in self.slots:
            if slot.free:
                continue
            req = slot.request
            if req.n_requeues >= self.rcfg.max_requeues:
                raise RuntimeError(
                    f"request {req.rid} exceeded max_requeues="
                    f"{self.rcfg.max_requeues}; the event schedule never "
                    "leaves a healthy window to finish in")
            req.reset_for_requeue()
            victims.append(req)
            if self.spans is not None:
                # resets with first_token_ms: the wasted decode episode
                # closes, a fault_recovery span opens at the same stamp
                self.spans.on_requeue(req, self.clock.now(), fault=fault)
            if self.tracer.enabled:
                self.tracer.emit("request.requeue", track=f"slot:{slot.idx}",
                                 rid=req.rid, n_requeues=req.n_requeues)
            slot.request, slot.state, slot.last_tok = None, None, None
        for req in victims:
            self.queue.push(req, force=True)
        self.metrics.count("requests_requeued", len(victims))
        healed = self.health.replace_replica(self.clock.now())
        self.metrics.count("shards_healed", healed)
        if self.tracer.enabled:
            self.tracer.emit("shard.heal_all", track="rounds",
                             healed=healed, requeued=len(victims))
        self._reencode()

    # --------------------------------------------------------- admission ----
    def _admit(self):
        mask = self.health.mask
        for slot in self.slots:
            if not slot.free or not self.queue:
                continue
            req = self.queue.pop()
            now = self.clock.now()
            req.state = RequestState.RUNNING
            req.slot = slot.idx
            req.admitted_ms = now
            if self.executor is not None:
                tok = self.executor.admit(slot.idx, req.prompt, mask,
                                          tag=req.rid)
                slot.request = req
            else:
                logits, state = self.stepper.prefill(
                    request_batch(req.prompt), mask)
                t = self.stepper.greedy(logits)
                slot.request, slot.state, slot.last_tok = req, state, t
                tok = int(t[0, 0])
            slot.occupancies += 1
            req.tokens.append(tok)
            req.first_token_ms = now
            if self.spans is not None:
                self.spans.on_admit(
                    req, now,
                    prefill_wall_ms=self.stepper.last_prefill_wall_ms)
            self.metrics.count("requests_admitted")
            self.metrics.count("tokens_generated")
            if self.tracer.enabled:
                self.tracer.emit("request.admit", track=f"slot:{slot.idx}",
                                 t_ms=now, rid=req.rid,
                                 queueing_ms=req.queueing_ms,
                                 n_requeues=req.n_requeues)
                self.tracer.emit("request.first_token",
                                 track=f"slot:{slot.idx}", t_ms=now,
                                 rid=req.rid, ttft_ms=req.ttft_ms)
            if req.done:
                self._complete(slot)

    def _complete(self, slot: _Slot):
        req = slot.request
        req.state = RequestState.COMPLETED
        req.finished_ms = self.clock.now()
        self.completed.append(req)
        if self.spans is not None:
            self.spans.on_complete(req, req.finished_ms)
        self.metrics.count("requests_completed")
        self.metrics.observe_request(req.latency_ms, req.queueing_ms,
                                     ttft_ms=req.ttft_ms)
        if self.tracer.enabled:
            # span over the slot occupancy: admit -> last token
            self.tracer.emit("request.complete", track=f"slot:{slot.idx}",
                             t_ms=req.admitted_ms,
                             dur_ms=req.finished_ms - req.admitted_ms,
                             rid=req.rid, n_tokens=len(req.tokens),
                             latency_ms=req.latency_ms,
                             ttft_ms=req.ttft_ms,
                             n_requeues=req.n_requeues)
        # the slot (and its KV-cache row) is immediately reusable
        slot.request, slot.state, slot.last_tok = None, None, None
        if self.executor is not None:
            self.executor.evict(slot.idx)

    # -------------------------------------------------------------- step ----
    def step(self) -> list[Request]:
        """One decode round: run the round hooks (chaos injector, adaptive
        planner), apply due health events, admit into free slots, decode
        one token per occupied slot, and advance the clock."""
        self.metrics.mark(self.clock.now())
        for hook in self.round_hooks:
            hook(self)
        self._handle_health()
        self._admit()

        if self.executor is not None:
            finished = self._step_batched()
        else:
            finished = self._step_sequential()

        self.metrics.count("decode_rounds")
        self._advance_clock()
        self.metrics.sample_queue_depth(self.clock.now(), len(self.queue))
        self.metrics.mark(self.clock.now())
        return finished

    def _step_batched(self) -> list[Request]:
        finished: list[Request] = []
        ready = self.executor.step_round(self.health.mask)
        for slot_idx, rid, tok in ready:
            slot = self.slots[slot_idx]
            # stale harvest: occupant changed (completed/requeued) between
            # dispatch and harvest, or already hit its token budget
            if slot.free or slot.request.rid != rid or slot.request.done:
                continue
            slot.request.tokens.append(tok)
            self.metrics.count("tokens_generated")
            if slot.request.done:
                finished.append(slot.request)
                self._complete(slot)
        return finished

    def _step_sequential(self) -> list[Request]:
        finished: list[Request] = []
        mask = self.health.mask
        t0 = time.perf_counter()
        stepped = False
        for slot in self.slots:
            if slot.free or slot.request.done:
                continue
            logits, slot.state = self.stepper.decode_one(
                slot.state, slot.last_tok, mask)
            slot.last_tok = self.stepper.greedy(logits)
            # the host int waits for the step: the round is synchronous
            slot.request.tokens.append(int(slot.last_tok[0, 0]))
            stepped = True
            self.metrics.count("tokens_generated")
            if slot.request.done:
                finished.append(slot.request)
                self._complete(slot)
        if stepped:
            self.metrics.observe_round_ms((time.perf_counter() - t0) * 1e3)
        return finished

    def _round_latency(self) -> tuple[float, float]:
        """(dt, stall) of the round that just ran: the simulated-clock
        advance plus the deterministic straggler/fault excess over a
        fault-free round (0 outside the injected-latency path: the plain
        StragglerModel draw and the fixed step time model no fault)."""
        T, r = self.stepper.n_shards, 0
        if self.stepper.coded:
            r = int(self.stepper.model.ctx.code_r)
        if self.latency is not None:
            # injected latency: same fault schedule as the health events
            dt = self.latency.round_ms(self.clock.now(), T, r,
                                       mask=self.health.mask)
            return dt, float(getattr(self.latency, "last_stall_ms", 0.0))
        if self.rcfg.straggler is not None:
            times = self.rcfg.straggler.sample(self._rng, (T + r,))
            # coded rounds finish at the T-th of T+r arrivals; uncoded
            # rounds wait for all T shards (paper §6.2)
            dt = float(request_latency(times, T)) if r \
                else float(times[:T].max())
            return dt, 0.0
        return self.rcfg.step_time_ms, 0.0

    def _round_id(self) -> int:
        """Id of the round this step ran: the executor's dispatch counter
        on the batched path (matches the ``round`` arg of its
        round.dispatch event), the decode_rounds counter otherwise."""
        if self.executor is not None:
            return self.executor.vstep.n_dispatches
        return self.metrics.counters["decode_rounds"]

    def _advance_clock(self):
        if not isinstance(self.clock, SimClock):
            return
        dt, stall = self._round_latency()
        if self.spans is not None:
            # decode slices tile each occupancy: [now, now + dt] for every
            # slot still occupied after this round's harvest (a request
            # completed or requeued this round already closed its decode
            # span at `now`, which is exactly where its last slice ended)
            now = self.clock.now()
            ridx = self._round_id()
            for slot in self.slots:
                if not slot.free:
                    self.spans.on_round(slot.request.rid, now, dt, ridx,
                                        stall_ms=stall)
        self.clock.advance(dt)

    # --------------------------------------------------------------- run ----
    def run(self) -> list[Request]:
        """Drain queue + slots. Returns all requests completed so far."""
        rounds = 0
        while self.busy:
            self.step()
            rounds += 1
            if rounds > self.rcfg.max_rounds:
                raise RuntimeError(
                    f"scheduler did not drain in {self.rcfg.max_rounds} "
                    "rounds")
        return self.completed


def run_arrivals(sched: ContinuousBatchingScheduler,
                 arrivals: list[tuple]) -> list[Request]:
    """Drive a timed workload: ``arrivals`` is [(time_ms, prompt,
    max_new_tokens)]. Requests are submitted when the (simulated) clock
    reaches their arrival time; idle gaps fast-forward the clock."""
    pending = deque(sorted(arrivals, key=lambda a: a[0]))
    rounds = 0
    while pending or sched.busy:
        if pending and not sched.busy and \
                pending[0][0] > sched.clock.now() and \
                isinstance(sched.clock, SimClock):
            sched.clock.advance_to(pending[0][0])
        while pending and pending[0][0] <= sched.clock.now():
            t, prompt, n = pending.popleft()
            sched.submit(prompt, n, arrival_ms=t)
        sched.step()
        rounds += 1
        if rounds > sched.rcfg.max_rounds:
            raise RuntimeError(
                f"workload did not drain in {sched.rcfg.max_rounds} rounds")
    return sched.completed
