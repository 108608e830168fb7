"""Shard-health controller: live validity masks + the CDC+2MR hybrid.

Consumes erasure/recovery events (``core.failure``'s erasure-channel view
of hardware) and decides, per event, which half of the paper's §6.3 hybrid
policy applies:

  * within the code's erasure budget  -> flip the validity mask and keep
    decoding; the coded GEMMs recover in-step (CDC path, close-to-zero
    recovery, §5.2);
  * beyond the budget (or a whole-replica failure) -> the 2MR fallback:
    in-flight requests are requeued, the shard set is replaced by the
    standby replica (heal-all), and parity weights are re-encoded offline;
  * shard recovery -> heal the shard and re-encode parity so the restored
    device rejoins the code.

The budget comes from the code geometry (``CodedDenseSpec.
max_device_failures``) and is only granted when the model's split method
is CDC-suitable per ``core.policy`` Table 1 — input-split layers cannot be
protected offline, so their runtime budget is zero regardless of r.

A copy of the reference package's controller, with its mesh-placement
helpers on the port's ``dist.sharding.Mesh``: coded shard i is model-rank
i, so an erasure names the ranks (one per data replica) that hold it.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np

from repro_torch.core.policy import OUTPUT_SPLIT, SplitMethod


class EventKind(enum.Enum):
    ERASURE = "erasure"                  # one shard's output lost
    RECOVERY = "recovery"                # a dead shard came back
    REPLICA_FAILURE = "replica_failure"  # whole serving replica lost


class HealthAction(enum.Enum):
    CONTINUE = "continue"    # mask updated; coded math absorbs the loss
    REQUEUE = "requeue"      # beyond budget: 2MR fallback, drain + heal
    REENCODE = "reencode"    # healed: parity weights must be re-encoded
    NOOP = "noop"            # duplicate report; state already reflects it


@dataclasses.dataclass(frozen=True, order=True)
class ShardEvent:
    time_ms: float
    kind: EventKind = dataclasses.field(compare=False)
    shard: int = dataclasses.field(default=-1, compare=False)


def erasure(time_ms: float, shard: int) -> ShardEvent:
    return ShardEvent(time_ms, EventKind.ERASURE, shard)


def recovery(time_ms: float, shard: int) -> ShardEvent:
    return ShardEvent(time_ms, EventKind.RECOVERY, shard)


def replica_failure(time_ms: float) -> ShardEvent:
    return ShardEvent(time_ms, EventKind.REPLICA_FAILURE)


class ShardHealthController:
    def __init__(self, n_shards: int, budget: int,
                 split: SplitMethod = OUTPUT_SPLIT,
                 events: list[ShardEvent] | None = None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards
        self.split = split
        # Table 1 gate: an unsuitable split cannot carry offline parity, so
        # every failure is beyond-budget no matter how many parity shards
        # were provisioned.
        self.budget = budget if split.suitable_for_cdc else 0
        self.valid = np.ones(n_shards, bool)
        self._pending: list[ShardEvent] = sorted(events or [])
        self.log: list[tuple[ShardEvent, HealthAction]] = []
        # observers (e.g. ``obs.ShardTimeline``): notified of every applied
        # event (``on_health(ev, action, mask)``) and of replica swaps
        # (``on_heal_all(t_ms, healed_shards, mask)``) — the single source
        # of truth for per-shard health timelines
        self.observers: list = []
        # high-water mark of concurrent dead shards since the last drain —
        # a beyond-budget burst heals in the same round (replace_replica),
        # so per-round mask sampling alone would never see it; the
        # adaptive planner drains this per estimation window
        self.peak_dead = 0

    # ----------------------------------------------------------- events ----
    def schedule(self, event: ShardEvent):
        self._pending.append(event)
        self._pending.sort()

    def poll(self, now_ms: float) -> list[HealthAction]:
        """Apply every pending event due at or before ``now_ms``."""
        return [a for _, a in self.poll_events(now_ms)]

    def poll_events(self, now_ms: float
                    ) -> list[tuple[ShardEvent, HealthAction]]:
        """Like ``poll`` but keeps the event paired with its action, so
        callers (the scheduler's tracer wiring) can attribute each action
        to the shard that caused it."""
        out = []
        while self._pending and self._pending[0].time_ms <= now_ms:
            ev = self._pending.pop(0)
            out.append((ev, self.apply(ev)))
        return out

    def apply(self, ev: ShardEvent) -> HealthAction:
        if ev.kind is EventKind.ERASURE:
            if not (0 <= ev.shard < self.n_shards):
                raise ValueError(f"shard {ev.shard} out of range")
            if not self.valid[ev.shard]:
                # duplicate report of an already-dead shard: one physical
                # failure must count (and be recovered) exactly once
                action = HealthAction.NOOP
            else:
                self.valid[ev.shard] = False
                n_dead = int((~self.valid).sum())
                self.peak_dead = max(self.peak_dead, n_dead)
                action = (HealthAction.CONTINUE if n_dead <= self.budget
                          else HealthAction.REQUEUE)
        elif ev.kind is EventKind.RECOVERY:
            if self.valid[ev.shard]:
                action = HealthAction.NOOP
            else:
                self.valid[ev.shard] = True
                action = HealthAction.REENCODE
        elif ev.kind is EventKind.REPLICA_FAILURE:
            action = HealthAction.REQUEUE
        else:  # pragma: no cover
            raise ValueError(ev.kind)
        self.log.append((ev, action))
        for obs in self.observers:
            obs.on_health(ev, action, self.valid)
        return action

    # ---------------------------------------------------------- healing ----
    def set_budget(self, budget: int):
        """Re-size the erasure budget (adaptive redundancy planner entry).
        The Table-1 gate still applies: an unsuitable split keeps budget 0
        no matter what the planner provisions."""
        if budget < 0:
            raise ValueError(f"budget must be >= 0, got {budget}")
        self.budget = int(budget) if self.split.suitable_for_cdc else 0

    def replace_replica(self, t_ms: float | None = None) -> int:
        """2MR path: swap in the standby, all shards healthy again.

        ``t_ms`` timestamps the swap for health observers (per-shard
        down-interval closure); omitted, observers see the time of the
        last applied event. Returns the number of shards that were dead
        before the swap.
        """
        healed = [int(s) for s in np.flatnonzero(~self.valid)]
        self.valid[:] = True
        if t_ms is None:
            t_ms = self.log[-1][0].time_ms if self.log else 0.0
        for obs in self.observers:
            obs.on_heal_all(float(t_ms), healed, self.valid)
        return len(healed)

    def drain_peak_dead(self) -> int:
        """Return the concurrent-dead high-water mark since the previous
        drain and re-arm it at the current state."""
        peak, self.peak_dead = self.peak_dead, self.n_dead
        return peak

    @property
    def mask(self) -> np.ndarray:
        return self.valid.copy()

    @property
    def n_dead(self) -> int:
        return int((~self.valid).sum())

    # ------------------------------------------------- mesh placement ----
    # Under dist.sharding, coded shard i IS model-rank i: weight columns
    # [i*m_l, (i+1)*m_l) and folded parity slot i live on the ranks at
    # index i of the mesh's `model` axis (one rank per (pod, data)
    # replica). These helpers translate the controller's logical mask into
    # that placement, so erasure events can name real ranks and the
    # runtime can report which processes a CONTINUE is absorbing.

    def _model_axis(self, mesh, axis: str):
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh has no {axis!r} axis: "
                             f"{tuple(mesh.axis_names)}")
        if mesh.shape[axis] != self.n_shards:
            raise ValueError(
                f"mesh {axis!r} size {mesh.shape[axis]} != "
                f"n_shards {self.n_shards}: shard<->device map undefined")
        return list(mesh.axis_names).index(axis)

    def shard_devices(self, mesh, axis: str = "model") -> dict[int, tuple]:
        """shard i -> the mesh devices holding it (one per data replica)."""
        ax = self._model_axis(mesh, axis)
        devs = np.moveaxis(np.asarray(mesh.devices), ax, 0)
        return {i: tuple(devs[i].ravel()) for i in range(self.n_shards)}

    def device_mask(self, mesh, axis: str = "model") -> np.ndarray:
        """Validity broadcast onto mesh.devices' shape (True = healthy)."""
        ax = self._model_axis(mesh, axis)
        shape = [1] * np.asarray(mesh.devices).ndim
        shape[ax] = self.n_shards
        return np.broadcast_to(
            self.valid.reshape(shape), np.asarray(mesh.devices).shape
        ).copy()

    def dead_devices(self, mesh, axis: str = "model") -> tuple:
        """Flat tuple of mesh devices currently erased, placement order."""
        by_shard = self.shard_devices(mesh, axis)
        out = []
        for i in np.flatnonzero(~self.valid):
            out.extend(by_shard[int(i)])
        return tuple(out)
