"""Per-shard health timeline: the single source of truth for "how long
was device i actually unavailable".

``ShardHealthController`` knows the CURRENT mask and logs (event, action)
pairs, but nothing aggregates them per shard over time: the planner's
EWMA samples the mask per round, and ``BENCH_chaos.json`` reported only
global counters. ``ShardTimeline`` closes that gap — registered as a
health-controller observer it sees every mask transition at its exact
sim timestamp and maintains, per shard:

  * erasure / heal counts (split by heal cause: own recovery vs the 2MR
    replica swap that heals everything at once);
  * closed down-intervals (for the Perfetto shard tracks) and cumulative
    downtime;
  * the unavailability DUTY CYCLE — downtime / observed span — the same
    quantity the adaptive planner estimates per window, now measured
    exactly from the transition log.

Consistency invariant (pinned by tests): at any instant, the set of
shards with an OPEN down-interval equals ``~controller.mask``, and the
timeline's mean duty cycle is the exact integral the planner's per-round
sampling approximates.
"""
from __future__ import annotations

import numpy as np


class ShardTimeline:
    """Observer of ``ShardHealthController`` mask transitions.

    Wire with ``health.observers.append(timeline)`` (the scheduler does
    this automatically). Cost is O(1) per health event — it is always on,
    traced or not.
    """

    def __init__(self, n_shards: int, t0_ms: float = 0.0):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.t0_ms = float(t0_ms)
        self.last_ms = float(t0_ms)
        self.down_since = np.full(self.n_shards, np.nan)   # NaN = up
        self.downtime_ms = np.zeros(self.n_shards)
        self.erasures = np.zeros(self.n_shards, np.int64)
        self.recoveries = np.zeros(self.n_shards, np.int64)
        self.replica_heals = np.zeros(self.n_shards, np.int64)
        self.reencodes = 0
        # closed down-intervals: (shard, t_down_ms, t_up_ms, heal_cause)
        self.intervals: list[tuple[int, float, float, str]] = []

    # ------------------------------------------------- observer surface ----
    def on_health(self, ev, action, mask):
        """One applied health event (called by the controller)."""
        # Deferred import: repro_torch.runtime imports repro_torch.obs, so
        # a top-level import here would make the import order matter. The
        # controller calling us guarantees the module is already loaded.
        from repro_torch.runtime.health import EventKind, HealthAction
        t = float(ev.time_ms)
        self.last_ms = max(self.last_ms, t)
        if action is HealthAction.NOOP:
            return
        if ev.kind is EventKind.ERASURE:
            self._mark_down(ev.shard, t)
        elif ev.kind is EventKind.RECOVERY:
            self.recoveries[ev.shard] += 1
            self._mark_up(ev.shard, t, "recovery")
        # REPLICA_FAILURE flips no per-shard mask bit; the heal arrives
        # via on_heal_all when the runtime swaps the standby in.

    def on_heal_all(self, t_ms: float, healed: list[int], mask):
        """The 2MR replica swap: every dead shard healed at once."""
        self.last_ms = max(self.last_ms, float(t_ms))
        for s in healed:
            self.replica_heals[s] += 1
            self._mark_up(int(s), float(t_ms), "replica_swap")

    def on_reencode(self, t_ms: float):
        self.last_ms = max(self.last_ms, float(t_ms))
        self.reencodes += 1

    # ---------------------------------------------------------- marking ----
    def _mark_down(self, shard: int, t_ms: float):
        if not (0 <= shard < self.n_shards):
            raise ValueError(f"shard {shard} out of range")
        if np.isnan(self.down_since[shard]):
            self.down_since[shard] = t_ms
            self.erasures[shard] += 1

    def _mark_up(self, shard: int, t_ms: float, cause: str):
        t0 = self.down_since[shard]
        if np.isnan(t0):
            return                       # duplicate heal: nothing open
        self.downtime_ms[shard] += t_ms - t0
        self.intervals.append((shard, float(t0), float(t_ms), cause))
        self.down_since[shard] = np.nan

    # ------------------------------------------------------------- read ----
    @property
    def down_now(self) -> np.ndarray:
        """Bool [n_shards]: shards with an open down-interval."""
        return ~np.isnan(self.down_since)

    def duty_cycle(self, now_ms: float | None = None) -> np.ndarray:
        """Per-shard unavailability fraction over [t0, now]. Open
        intervals count up to ``now`` — the live view the planner's EWMA
        approximates by sampling the mask each round."""
        now = self.last_ms if now_ms is None else float(now_ms)
        span = max(now - self.t0_ms, 0.0)
        if span == 0.0:
            return np.zeros(self.n_shards)
        down = self.downtime_ms.copy()
        open_ = self.down_now
        down[open_] += now - self.down_since[open_]
        return down / span

    def all_intervals(self, now_ms: float | None = None
                      ) -> list[tuple[int, float, float, str]]:
        """Closed intervals plus open ones clipped at ``now`` (export)."""
        now = self.last_ms if now_ms is None else float(now_ms)
        out = list(self.intervals)
        for s in np.flatnonzero(self.down_now):
            t0 = float(self.down_since[s])
            out.append((int(s), t0, max(now, t0), "open"))
        return sorted(out, key=lambda iv: (iv[1], iv[0]))

    def snapshot(self, now_ms: float | None = None) -> dict:
        """JSON-serialisable per-shard report (BENCH_chaos source)."""
        now = self.last_ms if now_ms is None else float(now_ms)
        duty = self.duty_cycle(now)
        shards = [{
            "shard": i,
            "erasures": int(self.erasures[i]),
            "recoveries": int(self.recoveries[i]),
            "replica_heals": int(self.replica_heals[i]),
            "downtime_ms": float(self.downtime_ms[i]),
            "duty_cycle": float(duty[i]),
            "down_now": bool(self.down_now[i]),
        } for i in range(self.n_shards)]
        return {
            "t0_ms": self.t0_ms,
            "now_ms": now,
            "reencodes": self.reencodes,
            "mean_duty_cycle": float(duty.mean()),
            "max_duty_cycle": float(duty.max()),
            "total_erasures": int(self.erasures.sum()),
            "shards": shards,
        }
