"""Serve a request stream through the coded cluster runtime with a
mid-stream shard failure, on the port.

Reproduces the paper's Case Study II operationally, but under sustained
load instead of a single batch: six requests flow through a 2-slot
continuous-batching scheduler driven by the BATCHED slot executor (the
whole pool advances in one dispatch per round: on the card a fused round
of the coded-GEMM and fused-head kernels, replayed as a CUDA graph); a
shard dies while requests are decoding. The shard-health controller flips
the validity mask, the coded GEMMs recover inside the same round for every
slot at once, and every request completes with tokens IDENTICAL to the
fault-free run ("the system never loses a request", §6). Measured
wall-clock round latency is reported next to the paper's modelled
straggler numbers.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_cdc [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_config
from repro_torch.core import StragglerModel
from repro_torch.device import resolve_device, set_true_f32
from repro_torch.models import TPCtx, build
from repro_torch.runtime import (ContinuousBatchingScheduler, RuntimeConfig,
                                 ShardHealthController, erasure, run_arrivals)
from repro_torch.serve import ModelStepper

ARCH = "h2o-danube-1.8b"
CTX = TPCtx(tp=4, mode="coded", code_r=2, moe_capacity=0)
FAIL = (5.0, 1)                          # shard 1 dies at 5 ms, mid-stream


def make_model():
    return build(smoke_config(get_arch(ARCH)), CTX)


def init_params(model, device):
    """The stream's params: ``model.init`` from a generator seeded 0 on
    ``device``."""
    return model.init(torch.Generator(device=device).manual_seed(0),
                      device=device)


def arrivals(vocab: int, seed: int = 1) -> list[tuple]:
    """Six requests of 12 prompt tokens and 12 new ones, 2 ms apart (the
    reference's numpy draw)."""
    rng = np.random.default_rng(seed)
    return [(i * 2.0, rng.integers(0, vocab, 12), 12) for i in range(6)]


def serve(model, params, work: list[tuple], events: list) -> tuple:
    """(scheduler, {rid: tokens}) of ``work`` through a 2-slot scheduler
    under the health ``events``."""
    stepper = ModelStepper(model, params, max_len=64)
    health = ShardHealthController(stepper.n_shards,
                                   stepper.erasure_budget, events=events)
    sched = ContinuousBatchingScheduler(
        stepper, RuntimeConfig(n_slots=2), health=health)
    done = run_arrivals(sched, list(work))
    return sched, {r.rid: list(r.tokens) for r in done}


def run(model, params, work: list[tuple]) -> dict:
    """The stream fault-free and with shard 1 dying mid-stream; prints the
    reference's lines."""
    _, toks_ok = serve(model, params, work, [])
    sched_fail, toks_fail = serve(model, params, work, [erasure(*FAIL)])
    print("fault-free tokens[req 0]:", toks_ok[0])
    print("with-failure tokens[req 0]:", toks_fail[0])
    print("all requests completed:", len(toks_fail) == len(work))
    print("identical across all requests:", toks_ok == toks_fail)
    print("runtime metrics:", sched_fail.metrics.counters)
    vs = sched_fail.executor.vstep
    print(f"batched executor: {vs.n_dispatches} single-dispatch rounds, "
          f"{vs.n_captures} graph capture(s), {vs.n_replays} replay(s)")
    print("measured round latency:",
          sched_fail.metrics.snapshot()["round_latency_measured"])
    print("modelled straggler first-T-of-(T+r):",
          sched_fail.stepper.straggler_latency(StragglerModel(),
                                               n_trials=5000))
    return {"tokens_ok": toks_ok, "tokens_fail": toks_fail,
            "completed": len(toks_fail), "requests": len(work),
            "rounds": vs.n_dispatches, "captures": vs.n_captures,
            "replays": vs.n_replays,
            "counters": dict(sched_fail.metrics.counters)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    set_true_f32()
    model = make_model()
    return run(model, init_params(model, dev), arrivals(model.cfg.vocab))


if __name__ == "__main__":
    main()
