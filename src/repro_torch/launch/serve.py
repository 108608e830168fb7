"""Serving entry point of the port: one batch through ``ServingEngine``
with an optional mid-run shard erasure (the reference's
``launch.serve --legacy`` path).

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --coded \\
      --device cpu --fail-step 2 --fail-shard 1

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
from repro_torch.models import TPCtx, build
from repro_torch.serve import ServeConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--coded", action="store_true")
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--fail-step", type=int, default=-1,
                    help="decode step to kill the shard at")
    ap.add_argument("--fail-shard", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    set_true_f32()
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    ctx = TPCtx(tp=args.tp, mode="coded" if args.coded else "plain")
    model = build(cfg, ctx)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
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


if __name__ == "__main__":
    main()
