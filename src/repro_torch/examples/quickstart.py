"""Quickstart: the paper's CDC technique, on the port.

Builds a coded output-split GEMM (paper Eq. 7/11), kills a shard, and shows
the recovery combine reproducing the fault-free result — then the same
thing through a whole transformer. On the card the GEMM runs the coded-GEMM
kernel (recovery fused in), the parity encode the encode kernel, and the
model's norms the RMSNorm kernel.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_config
from repro_torch.core import (CodedDenseSpec, CodeSpec, coded_matmul,
                              make_parity_weights)
from repro_torch.device import resolve_device, set_true_f32
from repro_torch.models import TPCtx, build

T = 4                                    # output-split across 4 devices
R = 2
DEAD = 2                                 # the device that dies


def dead_mask() -> np.ndarray:
    """The validity mask with device ``DEAD`` down."""
    valid = np.ones(T, bool)
    valid[DEAD] = False
    return valid


def coded_gemm(x: torch.Tensor, w: torch.Tensor, valid) -> tuple:
    """(recovered, fault-free): x @ w coded at (T, R) folded under
    ``valid``, and the plain product."""
    spec = CodedDenseSpec(CodeSpec(n_shards=T, n_parity=R))  # folded
    w_cdc = make_parity_weights(w, spec)  # OFFLINE (paper §5.2): no inputs
    y = coded_matmul(x, w, w_cdc, spec, valid, use_fused=True)
    return y, x @ w


def model_under_failure(model, params, batch: dict, valid) -> tuple:
    """(fault-free logits, logits under ``valid``) of ``model.forward``."""
    with torch.no_grad():
        ok = model.forward(params, batch, np.ones(T, bool))
        dead = model.forward(params, batch, valid)
    return ok, dead


def inputs(device) -> dict:
    """The run's inputs from one generator seeded 0 on ``device``, in the
    order ``main`` draws them: x [8, 256], w [256, 512] / 16, the smoke
    granite-3-8b (coded at T, R folded), its params and tokens [2, 16]."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((8, 256), generator=gen, device=device)
    w = torch.randn((256, 512), generator=gen, device=device) / 16.0
    cfg = smoke_config(get_arch("granite-3-8b"))
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R))
    params = model.init(gen, device=device)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=gen,
                           device=device)
    return {"x": x, "w": w, "model": model, "params": params,
            "tokens": tokens}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    set_true_f32()
    a = inputs(dev)

    # ---- 1. one coded GEMM -------------------------------------------------
    valid = dead_mask()                  # device 2 dies
    y, ref = coded_gemm(a["x"], a["w"], valid)     # recovery fused in
    gemm_err = float((y - ref).abs().max())
    print("1. coded GEMM: max |recovered - fault-free| =", gemm_err)

    # ---- 2. a whole model under failure ------------------------------------
    ok, dead = model_under_failure(a["model"], a["params"],
                                   {"tokens": a["tokens"]}, valid)
    model_dev = float((ok - dead).abs().max())
    print("2. full model: max logit deviation under a dead shard =",
          model_dev)

    # ---- 3. the cost structure (paper §5.2 benefit 1) ----------------------
    print(f"3. hardware cost: CDC {(T + 1) / T:.2f}x vs 2MR 2.00x "
          f"(constant vs linear in devices)")
    return {"gemm_err": gemm_err, "model_dev": model_dev, "y": y,
            "logits_ok": ok, "logits_dead": dead}


if __name__ == "__main__":
    main()
