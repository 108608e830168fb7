"""Adaptive redundancy planner: close the loop from observed faults to r.

The runtime so far ran a *fixed* (T, r) parity budget. This planner
watches what actually happens — per-window device unavailability, the
worst number of concurrent dead shards, straggler pressure — and re-sizes
the redundancy to meet a target availability, applying the change through
the existing heal + parity re-encode path (``ModelStepper.set_code_r`` +
``ShardHealthController.set_budget``). The CDC-vs-2MR hybrid split is
part of the plan: CDC-suitable splits (Table 1, ``core.policy``) spend
the budget on parity shards (constant cost in device count); unsuitable
splits cannot carry offline parity, so the same tolerance target is met
with standby 2MR replicas instead (linear cost — the paper's headline
contrast).

Sizing: with per-device unavailability ``u`` (EWMA of the observed
dead-device-rounds fraction), concurrent dead shards are modelled as
Binomial(T, u); the budget ``b`` is the smallest count whose tail
``P(X > b) <= 1 - target``, floored by the worst concurrency actually
observed in the window (the estimator must never plan below reality).
Budget -> r via the code layout: folded parity tolerates ``r // 2``
device failures, dedicated tolerates ``r``. Raising r is immediate;
lowering waits ``cooldown_windows`` consecutive calm windows so a lull
between correlated bursts doesn't strip protection.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def binomial_tail(n: int, p: float, b: int) -> float:
    """P(X > b) for X ~ Binomial(n, p)."""
    if p <= 0.0:
        return 0.0
    if p >= 1.0:
        return 1.0 if b < n else 0.0
    return float(sum(math.comb(n, k) * p ** k * (1.0 - p) ** (n - k)
                     for k in range(b + 1, n + 1)))


def required_budget(n_devices: int, unavail: float, target: float,
                    b_max: int) -> int:
    """Smallest b <= b_max with P(concurrent dead > b) <= 1 - target."""
    for b in range(b_max + 1):
        if binomial_tail(n_devices, unavail, b) <= 1.0 - target:
            return b
    return b_max


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    target_availability: float = 0.999
    window_ms: float = 100.0       # estimation window (sim time)
    min_budget: int = 1            # never plan below this tolerance
    max_budget: int = 2            # cap (r <= 2*b folded / b dedicated)
    ewma: float = 0.5              # weight of the newest window estimate
    cooldown_windows: int = 2      # calm windows required before lowering

    def __post_init__(self):
        if not (0.0 < self.target_availability < 1.0):
            raise ValueError("target_availability must lie in (0, 1)")
        if self.window_ms <= 0:
            raise ValueError("window_ms must be > 0")
        if not (0 <= self.min_budget <= self.max_budget):
            raise ValueError("need 0 <= min_budget <= max_budget")
        if not (0.0 < self.ewma <= 1.0):
            raise ValueError("ewma must lie in (0, 1]")


@dataclasses.dataclass(frozen=True)
class RedundancyPlan:
    t_ms: float
    budget: int                    # concurrent device failures to tolerate
    r: int                         # parity shards implementing the budget
    standby_replicas: int          # 2MR half of the hybrid
    est_unavailability: float
    window_max_dead: int
    reason: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class AdaptiveRedundancyPlanner:
    """Windowed estimator + budget sizing; drive with ``observe_round``
    every decode round and act on what ``maybe_plan`` returns."""

    def __init__(self, cfg: PlannerConfig, n_shards: int,
                 layout: str = "folded", suitable: bool = True,
                 init_budget: int | None = None):
        if layout not in ("folded", "dedicated"):
            raise ValueError(layout)
        self.cfg = cfg
        self.n_shards = int(n_shards)
        self.layout = layout
        self.suitable = bool(suitable)
        self.budget = int(cfg.min_budget if init_budget is None
                          else init_budget)
        self.unavail = 0.0
        self.plans: list[RedundancyPlan] = []
        self._calm_windows = 0
        self._win_start: float | None = None
        self._win_rounds = 0
        self._win_dead_rounds = 0
        self._win_max_dead = 0

    # ------------------------------------------------------- observation ----
    def observe_round(self, now_ms: float, mask: np.ndarray):
        if self._win_start is None:
            self._win_start = float(now_ms)
        n_dead = int((~np.asarray(mask, bool)).sum())
        self._win_rounds += 1
        self._win_dead_rounds += n_dead
        self._win_max_dead = max(self._win_max_dead, n_dead)

    # ------------------------------------------------------------ sizing ----
    def r_for_budget(self, budget: int) -> int:
        """Parity shards implementing ``budget`` under the code layout
        (folded parity rides the data devices: a death costs the data
        shard AND its folded slices, hence the factor 2)."""
        if not self.suitable or budget == 0:
            return 0
        r = 2 * budget if self.layout == "folded" else budget
        return min(r, self.n_shards)     # CodeSpec caps r at T

    def maybe_plan(self, now_ms: float, health=None) -> RedundancyPlan | None:
        """Close the window if due; returns a plan exactly at window
        boundaries, None in between. ``health`` (the live
        ``ShardHealthController``) contributes its concurrent-dead
        high-water mark — a beyond-budget burst heals inside one round,
        so per-round mask samples alone would miss it."""
        if (self._win_start is None or self._win_rounds == 0
                or now_ms - self._win_start < self.cfg.window_ms):
            return None
        if health is not None:
            self._win_max_dead = max(self._win_max_dead,
                                     health.drain_peak_dead())
        u_win = self._win_dead_rounds / (self.n_shards * self._win_rounds)
        self.unavail = (self.cfg.ewma * u_win
                        + (1.0 - self.cfg.ewma) * self.unavail)
        need = required_budget(self.n_shards, self.unavail,
                               self.cfg.target_availability,
                               self.cfg.max_budget)
        # the estimator must never plan below observed reality
        need = max(need, min(self._win_max_dead, self.cfg.max_budget),
                   self.cfg.min_budget)
        if need > self.budget:
            self.budget, self._calm_windows = need, 0
            reason = f"raise: tail({self.unavail:.4f}) needs b={need}"
        elif need < self.budget:
            self._calm_windows += 1
            if self._calm_windows >= self.cfg.cooldown_windows:
                self.budget, self._calm_windows = need, 0
                reason = f"lower after {self.cfg.cooldown_windows} calm " \
                         f"windows: b={need}"
            else:
                reason = (f"hold b={self.budget} (calm "
                          f"{self._calm_windows}/"
                          f"{self.cfg.cooldown_windows})")
        else:
            self._calm_windows = 0
            reason = f"hold b={self.budget}"
        plan = RedundancyPlan(
            t_ms=float(now_ms), budget=self.budget,
            r=self.r_for_budget(self.budget),
            standby_replicas=(1 if self.suitable
                              else max(1, self.budget)),
            est_unavailability=float(self.unavail),
            window_max_dead=self._win_max_dead, reason=reason)
        self.plans.append(plan)
        self._win_start = float(now_ms)
        self._win_rounds = self._win_dead_rounds = self._win_max_dead = 0
        return plan


# ------------------------------------------------------------- wiring ----

def apply_plan(sched, plan: RedundancyPlan) -> bool:
    """Apply a plan to a live scheduler through the heal + re-encode path.

    Never shrinks the budget below the shards currently dead (a code that
    cannot cover the present mask would break in-flight decode). Returns
    True iff the code geometry actually changed (which re-encodes parity
    and retraces the round on its next dispatch).
    """
    stepper, health = sched.stepper, sched.health
    if not stepper.coded or plan.r == 0:
        return False
    r = plan.r
    if health.n_dead > plan.budget:
        layout = stepper.model.ctx.code_layout
        r = min(2 * health.n_dead if layout == "folded" else health.n_dead,
                stepper.n_shards)
    if not stepper.set_code_r(r):
        return False
    health.set_budget(stepper.erasure_budget)
    sched.metrics.count("replans")
    sched.metrics.count("parity_reencodes")
    shardlog = getattr(sched, "shardlog", None)
    if shardlog is not None:     # a resize re-encodes parity offline too
        shardlog.on_reencode(sched.clock.now())
    return True


def attach_planner(sched, planner: AdaptiveRedundancyPlanner):
    """Register the planner as a per-round scheduler hook: observe the
    current mask, re-plan at window boundaries, apply changes, and record
    the plan series into the run's metrics."""
    sched.planner = planner

    def hook(s):
        now = s.clock.now()
        planner.observe_round(now, s.health.mask)
        plan = planner.maybe_plan(now, health=s.health)
        if plan is not None:
            applied = apply_plan(s, plan)
            s.metrics.observe_plan(plan.as_dict(), applied)
            if s.tracer.enabled:
                d = plan.as_dict()
                s.tracer.emit("planner.plan", track="planner",
                              t_ms=d.pop("t_ms"), applied=applied, **d)
    sched.round_hooks.append(hook)
    return hook
