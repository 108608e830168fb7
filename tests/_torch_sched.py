"""Shared scaffolding of the port's scheduler tests: the reference
package's runtime and the port's side by side on the same params, and one
driver that runs a workload through either.

``make_pair`` initialises the reference granite-3-8b smoke model once per
process and carries its params into the port (``params_from_jax``), so
both steppers hold the same weights. ``serve`` takes a side (``JAX`` or
``PORT``) and plain-data descriptions of the fault events, the chaos
injector, the injected latency and the planner, so the same workload is
built from each package's own classes.
"""
from __future__ import annotations

import functools
import types

import jax
import numpy as np

from repro import faults as jfaults
from repro import runtime as jruntime
from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
from repro.core.failure import StragglerModel as JStraggler
from repro.models import TPCtx as JCtx, build as jbuild
from repro.obs.tracer import FlightRecorder as JRecorder
from repro.serve import ModelStepper as JStepper
from repro_torch import faults as tfaults
from repro_torch import runtime as truntime
from repro_torch.configs import get_arch, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.failure import StragglerModel as TStraggler
from repro_torch.models import TPCtx, build
from repro_torch.obs.tracer import FlightRecorder as TRecorder
from repro_torch.serve import ModelStepper

T = 4
GEN = 6
PROMPT_LEN = 8
JAX = types.SimpleNamespace(name="jax", rt=jruntime, faults=jfaults,
                            Straggler=JStraggler, Recorder=JRecorder)
PORT = types.SimpleNamespace(name="port", rt=truntime, faults=tfaults,
                             Straggler=TStraggler, Recorder=TRecorder)


@functools.lru_cache(maxsize=None)
def _reference_params():
    jcfg = jsmoke(jget_arch("granite-3-8b"))
    jmodel = jbuild(jcfg, JCtx(tp=T, mode="coded", code_r=2,
                               moe_capacity=0))
    return jcfg, jmodel.init(jax.random.PRNGKey(0))


def _strip_parity(tree):
    if isinstance(tree, dict):
        return {k: _strip_parity(v) for k, v in tree.items() if k != "cdc"}
    return tree


def make_pair(code_r: int = 2, coded: bool = True):
    """(reference stepper, port stepper, port config) over one set of
    weights; the uncoded pair is the coded weights without parity."""
    jcfg, jparams = _reference_params()
    mode = "coded" if coded else "plain"
    jmodel = jbuild(jcfg, JCtx(tp=T, mode=mode, code_r=code_r,
                               moe_capacity=0))
    jp = jparams if coded else _strip_parity(jparams)
    cfg = smoke_config(get_arch("granite-3-8b"))
    model = build(cfg, TPCtx(tp=T, mode=mode, code_r=code_r))
    params = params_from_jax(jax.tree.map(np.asarray, jp), model.ctx,
                             device="cpu")
    return (JStepper(jmodel, jp, max_len=48),
            ModelStepper(model, params, max_len=48), cfg)


def prompts(cfg, n: int, seed: int = 7) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, PROMPT_LEN) for _ in range(n)]


def _event(side, kind: str, t: float, shard: int = -1):
    if kind == "replica_failure":
        return side.rt.replica_failure(t)
    return getattr(side.rt, kind)(t, shard)


def build_sched(side, stepper, *, events=(), chaos=None, latency=None,
                planner=None, traced=False, **rcfg):
    """A scheduler of ``side``'s package. events: [(kind, t_ms, shard)];
    chaos: {"spec": ChaosSpec kwargs, "seed": s} or {"trace": records};
    latency: {"base": StragglerModel kwargs, "seed": s} over the chaos
    injector; planner: PlannerConfig kwargs; traced: record a flight
    recorder (``sched.tracer``)."""
    health = side.rt.ShardHealthController(
        stepper.n_shards, stepper.erasure_budget,
        events=[_event(side, *e) for e in events])
    sched = side.rt.ContinuousBatchingScheduler(
        stepper, side.rt.RuntimeConfig(**rcfg), health=health,
        tracer=side.Recorder() if traced else None)
    injector = None
    if chaos is not None:
        if "trace" in chaos:
            injector = side.faults.TraceInjector(chaos["trace"],
                                                 stepper.n_shards)
        else:
            injector = side.faults.FaultInjector(
                side.faults.ChaosSpec(**chaos["spec"]), stepper.n_shards,
                seed=chaos["seed"])
        side.faults.attach_chaos(sched, injector)
    if latency is not None:
        sched.latency = side.faults.InjectedLatency(
            side.faults.LatencySpec(base=side.Straggler(**latency["base"])),
            injector, seed=latency["seed"])
    if planner is not None:
        side.faults.attach_planner(sched, side.faults.AdaptiveRedundancyPlanner(
            side.faults.PlannerConfig(**planner), stepper.n_shards,
            layout=stepper.model.ctx.code_layout))
    return sched


def outcome(sched, done) -> dict:
    """What must agree between the two packages: completions (rid order
    and tokens), counters, the simulated-clock snapshot and the planner's
    decisions. The measured wall-clock series agrees only in count, and
    the reference's perf gauges are not ported."""
    snap = sched.metrics.snapshot()
    measured = snap.pop("round_latency_measured")
    snap.pop("perf", None)
    return {"done": [(r.rid, [int(t) for t in r.tokens]) for r in done],
            "counters": dict(sched.metrics.counters),
            "snapshot": snap, "n_measured": measured["n"],
            "shed": [r.rid for r in sched.shed],
            "mask": sched.health.mask.tolist()}


def serve(side, stepper, arrivals, **kw) -> tuple[dict, object]:
    """Run ``arrivals`` [(t_ms, prompt, n_tokens)] through ``run_arrivals``
    on a scheduler of ``side``'s package; returns (outcome, scheduler)."""
    sched = build_sched(side, stepper, **kw)
    done = side.rt.run_arrivals(sched, [tuple(a) for a in arrivals])
    return outcome(sched, done), sched


def both(pair, arrivals, **kw) -> tuple[dict, dict, object]:
    """The same workload through the reference and the port; returns
    (reference outcome, port outcome, port scheduler). ``use_fused`` goes
    to the port alone: the reference's fused round is Pallas, which runs
    interpreted (slowly) off the TPU."""
    jstepper, tstepper, _ = pair
    port_kw = dict(kw)
    kw.pop("use_fused", None)
    want, _ = serve(JAX, jstepper, arrivals, **kw)
    got, sched = serve(PORT, tstepper, arrivals, **port_kw)
    return want, got, sched
