"""Fault-injection chaos harness + adaptive redundancy planner.

Turns the runtime from "recovers when told a shard died" into "survives
and re-plans under realistic failure scenarios":

  * ``injector`` — seeded Weibull/exponential up-down churn, transient vs
    permanent failures, correlated wireless dropouts, and trace playback
    (the paper's 12-Pi rig flavour), feeding the existing
    ``ShardHealthController`` through the scheduler's per-round hook;
  * ``latency`` — an injected per-device latency process layered onto
    ``core.failure.StragglerModel`` so modelled and measured round
    latency describe the same fault schedule;
  * ``planner`` — estimates per-window failure rates from what the
    runtime observed and re-sizes r (and the CDC-vs-2MR hybrid split) to
    meet a target availability, applied through heal + parity re-encode;
  * ``seeds`` — one root seed fanned into independent streams so a whole
    chaos run replays bit-exact.
"""
from repro_torch.faults.injector import (ChaosSpec, FaultInjector, TraceInjector,
                                   churn_trace, load_trace,
                                   make_pi_rig_trace, parse_chaos,
                                   write_trace)
from repro_torch.faults.latency import (InjectedLatency, LatencySpec,
                                  measured_stall_hook)
from repro_torch.faults.planner import (AdaptiveRedundancyPlanner, PlannerConfig,
                                  RedundancyPlan, apply_plan,
                                  attach_planner, binomial_tail,
                                  required_budget)
from repro_torch.faults.seeds import stream_rng, stream_seed


def attach_chaos(sched, injector):
    """Register the injector as a per-round scheduler hook: every round,
    pump the fault events due by now into the health controller (which
    applies the CDC+2MR hybrid policy exactly as for hand-placed
    events), and reconcile permanently-dead devices the controller has
    since healed via a 2MR replica swap (the standby hardware resumes
    churning)."""
    sched.injector = injector
    sync = getattr(injector, "sync_replaced", None)

    def hook(s):
        now = s.clock.now()
        if sync is not None:
            sync(s.health.mask, now)
        for ev in injector.events_until(now):
            s.health.schedule(ev)
            s.metrics.count("faults_injected")
            if s.tracer.enabled:
                # one fault.inject per injected event; the scheduler's
                # health handling emits its resolution (fault.recovered /
                # fault.beyond_budget / fault.noop) when the event applies
                s.tracer.emit(
                    "fault.inject",
                    track=f"shard:{ev.shard}" if ev.shard >= 0 else "rounds",
                    t_ms=ev.time_ms, fault=ev.kind.value, shard=ev.shard)
    sched.round_hooks.append(hook)
    return hook


__all__ = [
    "ChaosSpec", "FaultInjector", "TraceInjector", "churn_trace",
    "load_trace", "make_pi_rig_trace", "parse_chaos", "write_trace",
    "InjectedLatency", "LatencySpec", "measured_stall_hook",
    "AdaptiveRedundancyPlanner", "PlannerConfig", "RedundancyPlan",
    "apply_plan", "attach_planner", "binomial_tail", "required_budget",
    "stream_rng", "stream_seed",
    "attach_chaos",
]
