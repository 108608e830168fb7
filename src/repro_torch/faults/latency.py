"""Injected per-device latency layered onto ``core.failure.StragglerModel``.

The scheduler's simulated clock normally advances by a *healthy-cluster*
first-T-of-(T+r) draw. Under chaos that understates reality: dead devices
contribute nothing, degraded devices respond slower, and an uncoded round
must wait for (or time out on) every straggler. ``InjectedLatency`` makes
the modelled round latency consult the SAME fault schedule the injector
feeds the health controller, so the modelled series
(``snapshot()["elapsed_ms"]`` etc.) and the measured wall-clock series
(``RuntimeMetrics.round_ms``) describe one consistent scenario and can be
compared side by side.

Model per round at time t (paper §6.2 order statistics, extended):

  * every responder draws ``base`` (floor + lognormal), multiplied by the
    injector's ``slowdown_at(t)`` for degraded devices;
  * dead devices (the health mask) never respond;
  * a coded round completes at the T-th arrival of the T + r responders
    that are still alive — in-budget erasures cost only the lost order
    statistic, the paper's close-to-zero recovery;
  * an uncoded round needs ALL T data devices; a dead one stalls the
    round until ``timeout_ms`` — the degraded-redistribution cliff CDC
    avoids.

``measured_stall_hook`` mirrors the same schedule into the MEASURED path:
an executor round hook that stalls the host dispatch by the modelled
stall times ``wall_scale`` (default 1/1000: 1 modelled ms = 1 wall µs),
so chaos benchmarks show the injected phases in ``round_ms`` without
slowing wall-clock runs materially.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.failure import StragglerModel
from repro_torch.core.seeds import stream_rng


@dataclasses.dataclass(frozen=True)
class LatencySpec:
    base: StragglerModel = dataclasses.field(default_factory=StragglerModel)
    timeout_ms: float = 1000.0     # uncoded stall on a dead device
    # folded layout (the repo default): parity slice j rides data device
    # j % T, so that device's death/slowdown takes its parity along.
    # Set False for the dedicated layout's independent parity devices.
    parity_rides_data: bool = True

    def __post_init__(self):
        if self.timeout_ms <= 0:
            raise ValueError("timeout_ms must be > 0")


class InjectedLatency:
    """Stateful modelled-latency process over an injector's schedule.

    Draws are an independent seeded stream (``faults.seeds``), so the
    scheduler, injector, and latency model reproduce bit-exact from one
    root seed no matter how often each draws.
    """

    def __init__(self, spec: LatencySpec, injector, seed: int = 0):
        self.spec = spec
        self.injector = injector
        self.rng = stream_rng(seed, "latency")
        self.last_round_ms: float = 0.0
        # stall = last round's excess over its FAULT-FREE counterfactual
        # (same base draw, no slowdowns, full mask): the deterministic
        # per-round straggler/fault cost obs.spans charges to the `stall`
        # span of every decode slice that rode the round
        self.last_stall_ms: float = 0.0

    def _shard_times(self, now_ms: float, T: int, r: int,
                     mask: np.ndarray | None,
                     base: np.ndarray | None = None) -> np.ndarray:
        """[T + r] per-responder times; dead responders are +inf."""
        times = self.spec.base.sample(self.rng, (T + r,)) \
            if base is None else base.copy()
        slow = self.injector.slowdown_at(now_ms)
        times[:T] *= slow[:T]
        if r and self.spec.parity_rides_data:
            times[T:] *= np.resize(slow[:T], r)
        if mask is not None:
            dead = ~np.asarray(mask, bool)
            times[:T][dead] = np.inf
            if r and self.spec.parity_rides_data:
                times[T:][np.resize(dead, r)] = np.inf
        return times

    def round_ms(self, now_ms: float, T: int, r: int,
                 mask: np.ndarray | None = None) -> float:
        """Modelled latency of one coded (r > 0) or uncoded (r == 0)
        decode round at ``now_ms`` under the injected fault state."""
        # ONE base draw per round (RNG consumption identical to before the
        # stall accounting existed — replays stay bit-exact): the clean
        # counterfactual reuses it with no slowdowns and a full mask.
        base = self.spec.base.sample(self.rng, (T + r,))
        if r:
            clean = float(np.sort(base)[T - 1])
        else:
            clean = float(base[:T].max())
        clean = min(clean, self.spec.timeout_ms)
        times = self._shard_times(now_ms, T, r, mask, base=base)
        if r:
            dt = float(np.sort(times)[T - 1])   # T-th of the T+r arrivals
        else:
            dt = float(times[:T].max())         # wait for every data shard
        dt = min(dt, self.spec.timeout_ms)
        self.last_round_ms = dt
        self.last_stall_ms = max(0.0, dt - clean)
        return dt


def measured_stall_hook(latency: InjectedLatency, wall_scale: float = 1e-3):
    """Executor round hook replaying the modelled stall into wall time.

    Stalls the dispatch by ``last_round_ms * wall_scale``. The scheduler
    draws the modelled latency AFTER dispatching, so the stall replayed
    into round N is round N-1's draw (round 1 is unstalled): the
    MEASURED ``RuntimeMetrics.round_ms`` series shows the same fault
    phases as the modelled one at a compressed timescale, shifted by one
    round at phase edges — a diagnostic overlay, not a synchronised
    measurement."""

    def hook(executor, valid):
        dt = latency.last_round_ms * wall_scale
        if dt > 0:
            time.sleep(dt / 1e3)
    return hook
