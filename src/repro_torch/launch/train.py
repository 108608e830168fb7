"""Training entry point of the port, as the reference package's
``launch.train`` runs it: the fault-tolerant ``Trainer`` (async atomic
checkpoints, auto-resume with the parity re-encoded, SIGTERM saves and
stops) over the synthetic (seed, step) token stream.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
      --smoke --coded --device cpu --steps 40

Prints ``step,loss`` rows every 5 steps and a ``# wall:`` line. --smoke
swaps in the reduced config and trains without rematerialisation; a full
config checkpoints every layer (remat "full"). Runs on the CUDA device
unless ``--device cpu`` is given; without a card and without that flag it
raises instead of running on the CPU. There the norms run kernel 6 and
its backward kernel, and the parity encode kernel 4.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_arch, smoke_config
from repro_torch.data import DataConfig
from repro_torch.device import resolve_device, set_true_f32
from repro_torch.models import TPCtx, build
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig, TrainConfig


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--coded", action="store_true",
                    help="CDC-coded TP (the paper's technique)")
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_train"))
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    set_true_f32()
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    ctx = TPCtx(tp=args.tp if args.coded else 1,
                mode="coded" if args.coded else "plain")
    model = build(cfg, ctx)
    trainer = Trainer(
        model,
        TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=max(args.steps // 4, 10), log_every=5,
                      device=str(device)),
        AdamWConfig(lr=args.lr, total_steps=args.steps, warmup_steps=10),
        TrainConfig(microbatches=args.microbatches,
                    remat="none" if args.smoke else "full"),
        DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                   global_batch=args.batch),
    )
    out = trainer.run(resume=not args.no_resume)
    print("step,loss")
    for step, loss in out["losses"]:
        print(f"{step},{loss:.4f}")
    print(f"# wall: {out['wall_s']:.1f}s  arch={cfg.name} coded={args.coded}")
    return out


if __name__ == "__main__":
    main()
