"""Serving entry point of the port: the continuous-batching scheduler with
CDC fault injection, as the reference package's ``launch.serve`` runs it.

Requests arrive every ``--arrival-gap-ms`` on the simulated clock and are
served by ``ContinuousBatchingScheduler`` over ``--batch`` decode slots.
A shard erasure can be placed at a simulated time (``--fail-time-ms``);
within the code's budget the round recovers in-step, beyond it the
CDC+2MR hybrid requeues, swaps the replica in and re-encodes the parity.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --coded \\
      --device cpu --chaos "exp:mtbf=800,mttr=120" --adapt-r --seed 0

``--chaos <spec|trace>`` drives the health controller with a seeded churn
process (or a JSONL trace), with the modelled round latency following the
same schedule; ``--adapt-r`` adds the adaptive redundancy planner, which
re-sizes r through ``ModelStepper.set_code_r``. ``--seed`` is the root
seed: the whole chaos run replays bit-exact. ``--legacy`` (or
``--fail-step``) runs the one-batch ``ServingEngine`` path instead.

Runs on the CUDA device unless ``--device cpu`` is given; without a card
and without that flag it raises instead of running on the CPU.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_config
from repro_torch.core.failure import StragglerModel
from repro_torch.device import resolve_device, set_true_f32
from repro_torch.faults import (AdaptiveRedundancyPlanner, InjectedLatency,
                                LatencySpec, PlannerConfig, attach_chaos,
                                attach_planner, measured_stall_hook,
                                parse_chaos)
from repro_torch.models import TPCtx, build
from repro_torch.runtime import (ContinuousBatchingScheduler, RuntimeConfig,
                                 ShardHealthController, erasure,
                                 run_arrivals)
from repro_torch.serve import ModelStepper, ServeConfig, ServingEngine


def _legacy(args, cfg, model, params):
    eng = ServingEngine(model, params, ServeConfig(
        max_len=args.prompt_len + args.gen_tokens + 8, batch=args.batch,
        cache_dtype=torch.float32))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab,
                                    (args.batch, args.prompt_len))}
    fail_at = {args.fail_step: args.fail_shard} if args.fail_step >= 0 \
        else None
    toks = eng.generate(batch, args.gen_tokens, fail_at=fail_at)
    print("generated tokens (first sequence):", toks[0].tolist())
    print("engine metrics:", eng.metrics)
    if args.coded:
        print("straggler model (first-T-of-T+r):",
              eng.straggler_latency(StragglerModel(), n_trials=5000))
    return toks


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--coded", action="store_true")
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2,
                    help="runtime: decode slots; legacy: batch size")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--arrival-gap-ms", type=float, default=2.0)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--fail-time-ms", type=float, default=-1.0,
                    help="inject a shard erasure at this simulated time")
    ap.add_argument("--fail-shard", type=int, default=1)
    ap.add_argument("--fail-step", type=int, default=-1,
                    help="legacy mode: decode step to kill the shard at")
    ap.add_argument("--legacy", action="store_true",
                    help="one batch through ServingEngine.generate")
    ap.add_argument("--sequential", action="store_true",
                    help="per-slot stepping (the test oracle) instead of "
                         "the batched executor")
    ap.add_argument("--no-overlap", action="store_true",
                    help="harvest each round synchronously (no pipelining)")
    ap.add_argument("--fused", action="store_true",
                    help="force the fused round (the CUDA kernels; their "
                         "plain versions on the CPU); default auto = on a "
                         "CUDA device")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request SLO deadline after arrival")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="shed requests beyond this queue depth")
    ap.add_argument("--chaos", default=None, metavar="SPEC|TRACE",
                    help="fault injection: churn spec "
                         "('weibull:mtbf=2000,mttr=120,groups=2,"
                         "burst_mtbf=4000') or a JSONL trace path")
    ap.add_argument("--adapt-r", action="store_true",
                    help="adaptive redundancy planner: re-size r from "
                         "observed failures (heal + parity re-encode)")
    ap.add_argument("--avail-target", type=float, default=0.999,
                    help="planner availability target")
    ap.add_argument("--plan-window-ms", type=float, default=300.0,
                    help="planner estimation window (sim time)")
    ap.add_argument("--seed", type=int, default=0,
                    help="root seed: stragglers, injector, and injected "
                         "latency all derive from it (bit-exact replay)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def build_scheduler(args, stepper: ModelStepper, layout: str):
    """The scheduler ``main`` runs, with the chaos injector and the
    planner attached as the flags ask."""
    events = [erasure(args.fail_time_ms, args.fail_shard)] \
        if args.fail_time_ms >= 0 else []
    health = ShardHealthController(stepper.n_shards, stepper.erasure_budget,
                                   events=events)
    rcfg = RuntimeConfig(n_slots=args.batch, batched=not args.sequential,
                         overlap=not args.no_overlap,
                         use_fused=True if args.fused else "auto",
                         max_queue_depth=args.max_queue_depth,
                         seed=args.seed)
    injector = latency = None
    if args.chaos:
        injector = parse_chaos(args.chaos, stepper.n_shards, seed=args.seed)
        latency = InjectedLatency(LatencySpec(), injector, seed=args.seed)
    sched = ContinuousBatchingScheduler(stepper, rcfg, health=health,
                                        latency=latency)
    if injector is not None:
        attach_chaos(sched, injector)
        if sched.executor is not None:
            sched.executor.round_hooks.append(measured_stall_hook(latency))
    if args.adapt_r:
        planner = AdaptiveRedundancyPlanner(
            PlannerConfig(target_availability=args.avail_target,
                          window_ms=args.plan_window_ms),
            stepper.n_shards, layout=layout,
            suitable=stepper.erasure_budget > 0 or not args.coded)
        attach_planner(sched, planner)
    return sched


def serve_requests(args, sched, vocab: int):
    """Submit ``--requests`` prompts (drawn from numpy seed 1, as the
    reference does) and drain the scheduler."""
    rng = np.random.default_rng(1)
    if args.deadline_ms is not None:
        for i in range(args.requests):
            t = i * args.arrival_gap_ms
            sched.submit(rng.integers(0, vocab, args.prompt_len),
                         args.gen_tokens, deadline_ms=t + args.deadline_ms)
        return sched.run()
    arrivals = [(i * args.arrival_gap_ms,
                 rng.integers(0, vocab, args.prompt_len), args.gen_tokens)
                for i in range(args.requests)]
    return run_arrivals(sched, arrivals)


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    set_true_f32()
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    ctx = TPCtx(tp=args.tp, mode="coded" if args.coded else "plain")
    model = build(cfg, ctx)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    if args.legacy or args.fail_step >= 0:
        return _legacy(args, cfg, model, params)

    stepper = ModelStepper(model, params,
                           max_len=args.prompt_len + args.gen_tokens + 8)
    sched = build_scheduler(args, stepper, model.ctx.code_layout)
    completed = serve_requests(args, sched, cfg.vocab)
    mode = "sequential" if sched.executor is None else \
        ("batched+overlap" if sched.rcfg.overlap else "batched")
    print(f"completed {len(completed)}/{args.requests} requests "
          f"({mode}; shed {len(sched.shed)})")
    if completed:
        print("tokens (first request):", completed[0].tokens)
    if sched.executor is not None:
        print(f"executor: {sched.executor.vstep.n_dispatches} round "
              f"dispatches ({sched.executor.vstep.last_variant} variant "
              f"last)")
    c = sched.metrics.counters
    if args.chaos:
        print(f"chaos: {c['faults_injected']} injected events, "
              f"{c['erasures_recovered']} recovered in-step, "
              f"{c['beyond_budget_failures']} beyond budget")
    if args.adapt_r and sched.metrics.plan_log:
        series = [(p["t_ms"], p["r"]) for p in sched.metrics.plan_log]
        print(f"planner: r series {series} (replans: {c['replans']})")
    print(sched.metrics.to_json())
    if args.coded:
        print("straggler model (first-T-of-T+r):",
              stepper.straggler_latency(StragglerModel(), n_trials=5000))
    return sched


if __name__ == "__main__":
    main()
