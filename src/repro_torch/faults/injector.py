"""Deterministic fault injection over the coded shard/device set.

The paper's premise is IoT hardware with "unstable latencies and
intermittent failures"; until now the runtime only reacted to hand-placed
``ShardEvent``s. This module generates realistic failure schedules and
drives the existing ``ShardHealthController`` with them, advancing on the
runtime's simulated clock so a whole chaos run replays bit-exact from one
root seed (``faults.seeds``).

Two interchangeable sources (same ``events_until`` / ``slowdown_at``
surface):

  * ``FaultInjector`` — a seeded per-device up/down churn process:
    time-to-failure is exponential or Weibull (wear-out / infant
    mortality), repairs are exponential, a failure can be *transient*
    (erasure + later recovery), *permanent* (erasure, device never
    returns — only a 2MR replica swap heals it), or *degraded* (the
    device stays up but slow — no mask flip, picked up by the injected
    latency process). Correlated wireless dropouts model the paper's
    RPi-over-WiFi rig: devices are partitioned into AP groups and a
    burst takes a whole group down at once.
  * ``TraceInjector`` — plays back a recorded schedule (JSONL), e.g. the
    bundled 12-Pi-rig-flavoured trace of ``make_pi_rig_trace``, or any
    hand-written scenario.

The scheduler's per-round injection hook pumps ``events_until(now)`` into
``ShardHealthController.schedule``; the injector never touches masks
directly, so the CDC+2MR hybrid policy (budget gate, requeue, heal,
re-encode) stays the single decision point.
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import math
import os

import numpy as np

from repro_torch.core.seeds import stream_rng
from repro_torch.runtime.health import (EventKind, ShardEvent, erasure, recovery,
                                  replica_failure)

UP, DOWN, DEAD, DEGRADED = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Parameters of the churn process (all times in ms, per device)."""

    mtbf_ms: float = 400.0        # mean time between failures
    mttr_ms: float = 50.0         # mean transient repair time
    fail_dist: str = "exponential"   # "exponential" | "weibull"
    weibull_k: float = 1.5        # Weibull shape (>1: wear-out tail)
    p_permanent: float = 0.0      # failure is permanent (no recovery event)
    p_degraded: float = 0.0       # failure is a slowdown, not an erasure
    degraded_factor: float = 4.0  # latency multiplier while degraded
    groups: int = 0               # wireless AP groups (0: no bursts)
    burst_mtbf_ms: float = 0.0    # mean time between correlated dropouts
    burst_down_ms: float = 30.0   # dropout duration (whole group down)

    def __post_init__(self):
        if self.mtbf_ms <= 0 or self.mttr_ms <= 0:
            raise ValueError("mtbf_ms/mttr_ms must be > 0")
        if self.fail_dist not in ("exponential", "weibull"):
            raise ValueError(f"unknown fail_dist {self.fail_dist!r}")
        if self.weibull_k <= 0:
            raise ValueError("weibull_k must be > 0")
        if not (0 <= self.p_permanent + self.p_degraded <= 1):
            raise ValueError("p_permanent + p_degraded must lie in [0, 1]")
        if self.groups and self.burst_mtbf_ms <= 0:
            raise ValueError("groups > 0 needs burst_mtbf_ms > 0")


class FaultInjector:
    """Seeded churn over ``n_shards`` devices; see module docstring."""

    def __init__(self, spec: ChaosSpec, n_shards: int, seed: int = 0):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.spec = spec
        self.n_shards = int(n_shards)
        self.seed = int(seed)
        self.rng = stream_rng(seed, "injector")
        self.state = np.full(self.n_shards, UP, np.int8)
        self._burst_down: set[int] = set()
        # degraded intervals (t0, t1, shard, factor) for slowdown_at()
        self.degraded: list[tuple[float, float, int, float]] = []
        self._now = 0.0
        self._seq = 0
        self._heap: list[tuple[float, int, str, int]] = []
        for d in range(self.n_shards):
            self._push(self._draw_ttf(), "fail", d)
        if spec.groups:
            self._push(self.rng.exponential(spec.burst_mtbf_ms), "burst", -1)

    # ---------------------------------------------------------- process ----
    def _push(self, t: float, kind: str, who: int):
        heapq.heappush(self._heap, (float(t), self._seq, kind, who))
        self._seq += 1

    def _draw_ttf(self) -> float:
        s = self.spec
        if s.fail_dist == "weibull":
            # scale so the mean stays mtbf_ms regardless of shape k
            scale = s.mtbf_ms / math.gamma(1.0 + 1.0 / s.weibull_k)
            return scale * float(self.rng.weibull(s.weibull_k))
        return float(self.rng.exponential(s.mtbf_ms))

    def _draw_repair(self) -> float:
        return float(self.rng.exponential(self.spec.mttr_ms))

    def _group(self, g: int) -> list[int]:
        return [d for d in range(self.n_shards)
                if d % self.spec.groups == g]

    def events_until(self, now_ms: float) -> list[ShardEvent]:
        """Advance the churn process to ``now_ms`` (monotone) and return
        every mask-flip event that fired, in time order."""
        if now_ms < self._now:
            raise ValueError(f"injector time went backwards: "
                             f"{now_ms} < {self._now}")
        self._now = float(now_ms)
        out: list[ShardEvent] = []
        s = self.spec
        while self._heap and self._heap[0][0] <= now_ms:
            t, _, kind, who = heapq.heappop(self._heap)
            if kind == "fail":
                if self.state[who] != UP:       # already down/degraded
                    self._push(t + self._draw_ttf(), "fail", who)
                    continue
                u = float(self.rng.random())
                dur = self._draw_repair()
                if u < s.p_degraded:
                    self.state[who] = DEGRADED
                    self.degraded.append((t, t + dur, who,
                                          s.degraded_factor))
                    self._push(t + dur, "undegrade", who)
                elif u < s.p_degraded + s.p_permanent:
                    self.state[who] = DEAD      # only a replica swap heals
                    out.append(erasure(t, who))
                else:
                    self.state[who] = DOWN
                    out.append(erasure(t, who))
                    self._push(t + dur, "repair", who)
            elif kind == "repair":
                if self.state[who] == DOWN:
                    self.state[who] = UP
                    out.append(recovery(t, who))
                    self._push(t + self._draw_ttf(), "fail", who)
            elif kind == "undegrade":
                if self.state[who] == DEGRADED:
                    self.state[who] = UP
                    self._push(t + self._draw_ttf(), "fail", who)
            elif kind == "burst":
                g = int(self.rng.integers(s.groups))
                for d in self._group(g):
                    if self.state[d] == UP:
                        self.state[d] = DOWN
                        self._burst_down.add(d)
                        out.append(erasure(t, d))
                self._push(t + s.burst_down_ms, "burst_end", g)
                self._push(t + self.rng.exponential(s.burst_mtbf_ms),
                           "burst", -1)
            elif kind == "burst_end":
                for d in self._group(who):
                    if d in self._burst_down:
                        self._burst_down.discard(d)
                        self.state[d] = UP
                        out.append(recovery(t, d))
                        # the device's own pending "fail" stream survived
                        # the burst (it reschedules itself while non-UP),
                        # so restoring UP must NOT push another one — that
                        # would multiply failure streams per burst
        return out

    def sync_replaced(self, healthy_mask, now_ms: float):
        """Reconcile with the runtime's 2MR heal: a permanently-DEAD
        device that the health controller now reports healthy was
        physically replaced by a standby — resume its churn (fresh
        failure stream) so long runs don't progressively retire devices
        from the fault process."""
        for d in np.flatnonzero(np.asarray(healthy_mask, bool)):
            if self.state[d] == DEAD:
                self.state[d] = UP
                self._push(now_ms + self._draw_ttf(), "fail", int(d))

    def slowdown_at(self, t_ms: float) -> np.ndarray:
        """Per-device latency multiplier at ``t_ms`` (1.0 = healthy).
        Only valid up to the time the process has been advanced to.
        Expired intervals are pruned (``t_ms`` rises monotonically in
        runtime use), keeping the per-round scan bounded by the number
        of CONCURRENTLY degraded devices, not run length."""
        self.degraded = [iv for iv in self.degraded if iv[1] > t_ms]
        f = np.ones(self.n_shards, np.float64)
        for t0, t1, d, factor in self.degraded:
            if t0 <= t_ms < t1:
                f[d] = max(f[d], factor)
        return f

    # ------------------------------------------------------------ trace ----
    def to_trace(self, horizon_ms: float) -> list[dict]:
        """Run the process to ``horizon_ms`` and serialise the schedule
        (mask events + degraded intervals) as trace records. Use a FRESH
        injector: events are consumed exactly once and ``slowdown_at``
        prunes finished degraded intervals."""
        records = [_event_record(ev) for ev in self.events_until(horizon_ms)]
        records += [{"t_ms": t0, "kind": "degraded", "shard": d,
                     "until_ms": t1, "factor": f}
                    for t0, t1, d, f in self.degraded if t0 < horizon_ms]
        records.sort(key=lambda r: r["t_ms"])
        return records


# ------------------------------------------------------- trace playback ----

def _event_record(ev: ShardEvent) -> dict:
    return {"t_ms": ev.time_ms, "kind": ev.kind.value, "shard": ev.shard}


class TraceInjector:
    """Plays a recorded fault schedule back (same surface as the churn
    injector). Records: {"t_ms", "kind": erasure|recovery|replica_failure|
    degraded, "shard", ["until_ms", "factor"]}."""

    def __init__(self, records: list[dict], n_shards: int):
        self.n_shards = int(n_shards)
        self._events: list[ShardEvent] = []
        self.degraded: list[tuple[float, float, int, float]] = []
        for r in sorted(records, key=lambda r: float(r["t_ms"])):
            t, kind = float(r["t_ms"]), str(r["kind"])
            shard = int(r.get("shard", -1))
            if kind == "replica_failure":
                self._events.append(replica_failure(t))
                continue
            if not (0 <= shard < self.n_shards):
                raise ValueError(
                    f"trace names shard {shard} but the runtime has "
                    f"{self.n_shards} — record the trace for this rig or "
                    "shrink it")
            if kind == "degraded":
                self.degraded.append((t, float(r["until_ms"]), shard,
                                      float(r.get("factor", 4.0))))
                continue
            self._events.append(ShardEvent(t, EventKind(kind), shard))
        self._cursor = 0
        self._now = 0.0

    @classmethod
    def from_file(cls, path: str, n_shards: int) -> "TraceInjector":
        return cls(load_trace(path), n_shards)

    def events_until(self, now_ms: float) -> list[ShardEvent]:
        if now_ms < self._now:
            raise ValueError(f"injector time went backwards: "
                             f"{now_ms} < {self._now}")
        self._now = float(now_ms)
        out = []
        while (self._cursor < len(self._events)
               and self._events[self._cursor].time_ms <= now_ms):
            out.append(self._events[self._cursor])
            self._cursor += 1
        return out

    def slowdown_at(self, t_ms: float) -> np.ndarray:
        f = np.ones(self.n_shards, np.float64)
        for t0, t1, d, factor in self.degraded:
            if t0 <= t_ms < t1:
                f[d] = max(f[d], factor)
        return f


def write_trace(path: str, records: list[dict]):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r, sort_keys=True) + "\n")


def load_trace(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ------------------------------------------------------ canned schedules ----

def make_pi_rig_trace(horizon_ms: float = 2000.0, n_shards: int = 12,
                      seed: int = 0) -> list[dict]:
    """A schedule flavoured like the paper's 12-RPi-over-WiFi rig: three
    4-Pi AP groups with correlated dropouts, heavy transient churn, a
    small permanent-failure and degraded-mode tail."""
    spec = ChaosSpec(mtbf_ms=600.0, mttr_ms=80.0, fail_dist="weibull",
                     weibull_k=1.3, p_permanent=0.05, p_degraded=0.15,
                     degraded_factor=5.0, groups=3, burst_mtbf_ms=900.0,
                     burst_down_ms=40.0)
    return FaultInjector(spec, n_shards, seed=seed).to_trace(horizon_ms)


def churn_trace(n_shards: int, t0_ms: float, t1_ms: float, period_ms: float,
                down_ms: float, concurrent: int = 1,
                first_shard: int = 0) -> list[dict]:
    """A deterministic in-budget churn phase: every ``period_ms`` inside
    [t0, t1), ``concurrent`` distinct shards go down together and recover
    ``down_ms`` later (must be < period so outages never overlap the next
    wave). Shards rotate so every device takes its turn failing."""
    if down_ms >= period_ms:
        raise ValueError("down_ms must be < period_ms (waves must not "
                         "overlap)")
    if concurrent > n_shards:
        raise ValueError("concurrent outages cannot exceed n_shards")
    records, shard, t = [], first_shard, t0_ms
    while t + down_ms < t1_ms:
        for j in range(concurrent):
            d = (shard + j) % n_shards
            records.append({"t_ms": t, "kind": "erasure", "shard": d})
            records.append({"t_ms": t + down_ms, "kind": "recovery",
                            "shard": d})
        shard = (shard + concurrent) % n_shards
        t += period_ms
    return records


# -------------------------------------------------------------- parsing ----

_SPEC_KEYS = {
    "mtbf": "mtbf_ms", "mtbf_ms": "mtbf_ms",
    "mttr": "mttr_ms", "mttr_ms": "mttr_ms",
    "k": "weibull_k", "weibull_k": "weibull_k",
    "p_perm": "p_permanent", "p_permanent": "p_permanent",
    "p_deg": "p_degraded", "p_degraded": "p_degraded",
    "deg_factor": "degraded_factor", "degraded_factor": "degraded_factor",
    "groups": "groups",
    "burst_mtbf": "burst_mtbf_ms", "burst_mtbf_ms": "burst_mtbf_ms",
    "burst_down": "burst_down_ms", "burst_down_ms": "burst_down_ms",
}


def parse_chaos(arg: str, n_shards: int, seed: int = 0):
    """``--chaos`` argument -> injector. A path to a JSONL trace plays it
    back; otherwise a spec string like
    ``"weibull:mtbf=300,mttr=40,p_perm=0.05,groups=2,burst_mtbf=500"``
    (dist prefix optional, keys per ``ChaosSpec``)."""
    if os.path.exists(arg):
        return TraceInjector.from_file(arg, n_shards)
    dist, _, body = arg.partition(":")
    if not body:
        dist, body = "exponential", arg
    dist = {"exp": "exponential", "exponential": "exponential",
            "weibull": "weibull"}.get(dist)
    if dist is None:
        raise ValueError(f"unknown chaos distribution in {arg!r}")
    kw: dict = {"fail_dist": dist}
    for pair in filter(None, body.split(",")):
        key, _, val = pair.partition("=")
        field = _SPEC_KEYS.get(key.strip())
        if field is None:
            raise ValueError(f"unknown chaos spec key {key!r} "
                             f"(known: {sorted(set(_SPEC_KEYS))})")
        kw[field] = int(val) if field == "groups" else float(val)
    return FaultInjector(ChaosSpec(**kw), n_shards, seed=seed)
