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

Observability, as the reference's entry point has it: ``--trace PATH``
writes the flight recorder as a Perfetto/Chrome trace and validates it,
``--metrics-port`` serves live Prometheus text (``/metrics``) and the
trace (``/trace``), ``--slo-report`` prints the per-request TTFT/TPOT
breakdown, ``--perf`` prints the roofline attribution of the round (on
by itself with ``--trace``, ``--metrics-port`` or ``--profile``), and
``--profile DIR`` writes a ``torch.profiler`` trace of the run: it
attaches a timing flight recorder (``FlightRecorder(timing=True)``), so
the trace holds the host spans (``host.health``, ``host.admit_prefill``,
``host.admit``, ``host.prefill`` with ``host.prefill.state`` and
``host.prefill.forward``, ``host.first_token``, ``host.write_slot``,
``host.round_dispatch``, ``host.harvest_wait``, ``host.reencode``) and,
in each eager forward, ``host.layer.attn``, ``host.layer.ffn`` (or
``host.layer.moe``) and ``host.head``. With ``--trace`` as well, on a
card, the flight-recorder trace has a ``device`` track: each round's and
each prefill's device time from CUDA events, placed by one anchor taken
when the recorder attached, so the gaps between them are the device's
idle time (they keep real time between them; the other tracks are on the
run's simulated clock).

``--arch`` takes every config the port registers: the dense decoders,
hymba-1.5b (attention + mamba: the conv window and SSM state beside the
KV cache, slot axis 1), xlstm-125m (recurrent block state, slot axis 0),
the mixtures of experts qwen2-moe-a2.7b and qwen3-moe-235b-a22b (routed
experts uncoded beside coded shared ones, at capacity 0: no token is
dropped, as the reference's launcher builds them) and the
encoder-decoder whisper-medium, whose requests each carry their own
encoder frames (the frontend stub), drawn after the request's prompt:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \
      --smoke --coded --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
      --smoke --coded --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --smoke --coded --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \
      --smoke --coded --device cpu

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --coded \
      --device cpu --perf --slo-report --trace /tmp/t.json

Runs on the CUDA device unless ``--device cpu`` is given; without a card
and without that flag it raises instead of running on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
from pathlib import Path

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
from repro_torch.obs.export import (MetricsServer, validate_chrome_trace,
                                    write_chrome_trace)
from repro_torch.obs.tracer import FlightRecorder
from repro_torch.runtime import (ContinuousBatchingScheduler, RuntimeConfig,
                                 ShardHealthController, erasure,
                                 run_arrivals)
from repro_torch.serve import ModelStepper, ServeConfig, ServingEngine


def _legacy(args, model, params):
    eng = ServingEngine(model, params, ServeConfig(
        max_len=args.prompt_len + args.gen_tokens + 8, batch=args.batch,
        cache_dtype=torch.float32))
    batch = model.dummy_batch(np.random.default_rng(1), args.batch,
                              args.prompt_len)
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
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record the flight recorder and write a "
                         "Perfetto/Chrome trace_event JSON (open it at "
                         "https://ui.perfetto.dev)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve live Prometheus text metrics at "
                         "/metrics (and the trace at /trace) on this "
                         "port; 0 binds an ephemeral port")
    ap.add_argument("--slo-report", action="store_true",
                    help="print the per-request SLO breakdown after the "
                         "run: p50/p99 TTFT/TPOT decomposition tables and "
                         "deadline-miss attribution (same renderer as "
                         "python -m repro_torch.obs.slo report)")
    ap.add_argument("--perf", action="store_true",
                    help="roofline-anchored round attribution: useful vs "
                         "parity FLOPs, live coded_overhead_frac, achieved "
                         "vs roofline utilization on one H100 "
                         "(auto-enabled with --trace/--metrics-port/"
                         "--profile)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the run into DIR "
                         "with the host.* ranges of a timing flight "
                         "recorder (open with Perfetto); with --trace, its "
                         "device track on a card")
    return ap


def build_scheduler(args, stepper: ModelStepper, layout: str):
    """The scheduler ``main`` runs, with the chaos injector, the planner
    and the observability sinks attached as the flags ask."""
    events = [erasure(args.fail_time_ms, args.fail_shard)] \
        if args.fail_time_ms >= 0 else []
    health = ShardHealthController(stepper.n_shards, stepper.erasure_budget,
                                   events=events)
    # perf accounting rides along whenever any observability sink is on:
    # the counter track needs it for --trace, the gauges for --metrics-port
    perf = bool(args.perf or args.trace or args.metrics_port is not None
                or args.profile)
    rcfg = RuntimeConfig(n_slots=args.batch, batched=not args.sequential,
                         overlap=not args.no_overlap,
                         use_fused=True if args.fused else "auto",
                         max_queue_depth=args.max_queue_depth,
                         seed=args.seed, perf=perf)
    injector = latency = None
    if args.chaos:
        injector = parse_chaos(args.chaos, stepper.n_shards, seed=args.seed)
        latency = InjectedLatency(LatencySpec(), injector, seed=args.seed)
    tracer = FlightRecorder(timing=args.profile is not None) \
        if args.trace or args.metrics_port is not None or args.profile \
        else None
    sched = ContinuousBatchingScheduler(stepper, rcfg, health=health,
                                        latency=latency, tracer=tracer)
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


def _profiler(args, device: torch.device):
    """A torch.profiler over the run when ``--profile`` asks for one."""
    if not args.profile:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def serve_requests(args, sched):
    """Submit ``--requests`` prompts (drawn from numpy seed 1, as the
    reference does; an enc-dec request's frames right after its prompt,
    from the same generator) and drain the scheduler (under the profiler
    with ``--profile``, whose trace lands in ``DIR/trace.json``)."""
    cfg = sched.stepper.model.cfg
    rng = np.random.default_rng(1)

    def extras():
        # enc-dec: per-request encoder frames (the frontend stub), written
        # into the executor's cross-attention bank at admission
        if not cfg.is_encdec:
            return None
        return {"frames": rng.normal(
            size=(cfg.enc_seq, cfg.d_model)).astype(np.float32)}

    with _profiler(args, sched.stepper.device) as prof:
        if args.deadline_ms is not None:
            for i in range(args.requests):
                t = i * args.arrival_gap_ms
                sched.submit(rng.integers(0, cfg.vocab, args.prompt_len),
                             args.gen_tokens,
                             deadline_ms=t + args.deadline_ms,
                             extras=extras())
            completed = sched.run()
        else:
            arrivals = [(i * args.arrival_gap_ms,
                         rng.integers(0, cfg.vocab, args.prompt_len),
                         args.gen_tokens, extras())
                        for i in range(args.requests)]
            completed = run_arrivals(sched, arrivals)
    if args.profile:
        out = Path(args.profile)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
        print(f"profile: wrote torch.profiler trace to {out / 'trace.json'}")
    return completed


def report(args, sched, completed) -> dict:
    """Print the run's summary lines (and the SLO report, the perf line,
    the written trace's validation as the flags ask); returns the perf
    summary and trace statistics."""
    out: dict = {}
    mode = "sequential" if sched.executor is None else \
        ("batched+overlap" if sched.rcfg.overlap else "batched")
    print(f"completed {len(completed)}/{args.requests} requests "
          f"({mode}; shed {len(sched.shed)})")
    if completed:
        print("tokens (first request):", completed[0].tokens)
    if sched.executor is not None:
        vs = sched.executor.vstep
        print(f"executor: {vs.n_dispatches} round dispatches, "
              f"{vs.n_captures} graph capture(s), {vs.n_replays} "
              f"replay(s), graphs dropped {vs.n_graph_drops} time(s) "
              f"({vs.last_variant} variant last)")
        perf = sched.executor.perf
        if perf is not None and perf.n_observed:
            s = out["perf"] = perf.summary()
            print(f"perf: {s['model_flops'] / 1e6:.2f} MFLOP useful/round "
                  f"({s['coded_overhead_frac']:.3f} coded overhead, "
                  f"{s['parity_device_equiv']:.3f} parity device-equiv), "
                  f"{s['achieved_flops_per_s'] / 1e9:.2f} GFLOP/s achieved, "
                  f"{s['hbm_gbs']:.2f} GB/s, roofline utilization "
                  f"{s['roofline_utilization']:.4f} ({s['dominant']}-bound; "
                  f"bound {s['bound_step_us'] / 1e3:.3f} ms, "
                  f"{s['hbm_bytes'] / 1e9:.3f} GB, "
                  f"{s['hlo_flops'] / 1e9:.3f} GFLOP a {s['variant']} "
                  f"round, {s['custom_calls_uncosted']:.0f} uncosted)")
    c = sched.metrics.counters
    if args.chaos:
        print(f"chaos: {c['faults_injected']} injected events, "
              f"{c['erasures_recovered']} recovered in-step, "
              f"{c['beyond_budget_failures']} beyond budget")
    if args.adapt_r and sched.metrics.plan_log:
        series = [(p["t_ms"], p["r"]) for p in sched.metrics.plan_log]
        print(f"planner: r series {series} (replans: {c['replans']})")
    if args.slo_report and sched.spans is not None:
        from repro_torch.obs.slo import decompositions, render_report
        print("--- slo report " + "-" * 49)
        print(render_report(decompositions(sched.spans)))
        print("-" * 64)
    if args.trace:
        trace = write_chrome_trace(
            args.trace, sched.tracer, sched.shardlog,
            now_ms=sched.clock.now(),
            meta={"arch": args.arch, "seed": args.seed,
                  "chaos": args.chaos or "", "adapt_r": args.adapt_r},
            spans=sched.spans)
        stats = out["trace"] = validate_chrome_trace(
            trace, require_span_closure=sched.spans is not None
            and len(sched.spans.done) > 0)
        print(f"trace: wrote {args.trace} ({stats['n_events']} events on "
              f"{stats['n_tracks']} tracks; "
              f"{stats['n_injected_erasures']} injected erasures, all "
              f"linked to a resolution; {stats['n_span_trees']} request "
              f"span trees closed and gap-accounted"
              + (f"; {stats['n_device_spans']} device spans)"
                 if stats["n_device_spans"] else ")"))
    return out


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    set_true_f32()
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    ctx = TPCtx(tp=args.tp, mode="coded" if args.coded else "plain",
                moe_capacity=0)
    model = build(cfg, ctx)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    if args.legacy or args.fail_step >= 0:
        return _legacy(args, model, params)

    stepper = ModelStepper(model, params,
                           max_len=args.prompt_len + args.gen_tokens + 8)
    sched = build_scheduler(args, stepper, model.ctx.code_layout)
    server = None
    if args.metrics_port is not None:
        server = MetricsServer(sched.metrics, sched.shardlog, sched.tracer,
                               sched.clock, port=args.metrics_port,
                               spans=sched.spans).start()
        print(f"metrics: http://127.0.0.1:{server.port}/metrics "
              f"(live trace: /trace)")
    try:
        completed = serve_requests(args, sched)
        report(args, sched, completed)
    finally:
        if server is not None:
            server.stop()
        sched.tracer.detach()      # the model's profiler ranges go off
    print(sched.metrics.to_json())
    if args.coded:
        print("straggler model (first-T-of-T+r):",
              stepper.straggler_latency(StragglerModel(), n_trials=5000))
    return sched


if __name__ == "__main__":
    main()
