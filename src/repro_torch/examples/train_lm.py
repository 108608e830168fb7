"""End to end: train a ~100M-param LM for a few hundred steps, on
the port.

Uses the xlstm-125m assigned architecture (closest to 100M) at full config
and a short sequence. Checkpoints, auto-resumes, and logs loss. The params
come from the Trainer's seed and the batches from the synthetic (seed,
step) stream; on the card the norms run the RMSNorm kernel and its
backward.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 \\
          [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile

from repro_torch.configs import get_arch
from repro_torch.data import DataConfig
from repro_torch.device import resolve_device, set_true_f32
from repro_torch.models import TPCtx, build
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig, TrainConfig

SEED = 0


def train(steps: int, seq: int, batch: int, ckpt: str, device) -> dict:
    """The reference's run: xlstm-125m uncoded, AdamW lr 1e-3 with 20
    warmup steps, no remat, a checkpoint every 50 steps. Returns the
    Trainer's {"losses", "wall_s", ...}."""
    cfg = get_arch("xlstm-125m")  # 12L x 768d: ~125M params, full config
    model = build(cfg, TPCtx())
    trainer = Trainer(
        model,
        TrainerConfig(steps=steps, ckpt_dir=ckpt, ckpt_every=50,
                      log_every=10, seed=SEED, device=str(device)),
        AdamWConfig(lr=1e-3, total_steps=steps, warmup_steps=20),
        TrainConfig(microbatches=1, remat="none"),
        DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch),
    )
    return trainer.run()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_train_lm"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    set_true_f32()
    out = train(args.steps, args.seq, args.batch, args.ckpt, dev)
    print("step,loss")
    for s, l in out["losses"]:
        print(f"{s},{l:.4f}")
    first, last = out["losses"][0][1], out["losses"][-1][1]
    print(f"# loss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({out['wall_s']:.0f}s)")
    out["finite"] = all(math.isfinite(l) for _, l in out["losses"])
    return out


if __name__ == "__main__":
    main()
