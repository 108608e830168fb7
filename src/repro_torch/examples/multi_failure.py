"""Beyond the paper (§7/Fig. 18): MDS parity shards tolerate r failures.

Sweeps r = 1..4 on a T=8 output split; shows exact recovery for every
r-subset of failures tried, at (T+r)/T hardware cost — the paper's sketch
made rigorous with a totally-positive Vandermonde generator. On the card
the parity encode runs the encode kernel and a single erasure the
coded-GEMM kernel; two or more erasures take the library's solve, as the
reference's kernels do.

Run:  PYTHONPATH=src python -m repro_torch.examples.multi_failure \\
          [--device cpu]
"""
from __future__ import annotations

import argparse
import itertools

import numpy as np
import torch

from repro_torch.core import (CodedDenseSpec, CodeSpec, coded_matmul,
                              make_parity_weights, max_decode_condition)
from repro_torch.device import resolve_device, set_true_f32

T = 8
RS = (1, 2, 3, 4)
SUBSETS = 20                     # dead subsets tried for each r
# How far two correct sweeps' recovered outputs may lie apart, elementwise,
# by r: the solve amplifies each one's float32 rounding by the decode
# condition (1, 39, 7.2e2, 8.1e3). Read on the CPU against the JAX
# package: 3.3e-6, 2.7e-5, 4.6e-4, 4.2e-3; a sweep whose parity weights
# were rounded to bf16 lies 1.5e-2, 0.19, 1.9, 17 away.
AGREEMENT = {1: 1e-5, 2: 1e-4, 3: 1.5e-3, 4: 1.5e-2}


def inputs(device) -> tuple[torch.Tensor, torch.Tensor]:
    """x [4, 128] and w [128, 256] / 12 from a generator seeded 0 on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((4, 128), generator=gen, device=device)
    w = torch.randn((128, 256), generator=gen, device=device) / 12.0
    return x, w


def sweep_r(x: torch.Tensor, w: torch.Tensor, r: int) -> dict:
    """The decode condition at (T, r) dedicated, the recovered outputs
    [SUBSETS, rows, n] of the coded GEMM under the first ``SUBSETS``
    r-subsets of dead shards, and their worst error against x @ w."""
    spec = CodedDenseSpec(CodeSpec(T, r), layout="dedicated")
    cond = max_decode_condition(spec.code)
    w_cdc = make_parity_weights(w, spec)
    ref = x @ w
    ys = []
    for dead in itertools.islice(itertools.combinations(range(T), r),
                                 SUBSETS):
        valid = np.ones(T, bool)
        valid[list(dead)] = False
        ys.append(coded_matmul(x, w, w_cdc, spec, valid, use_fused=True))
    ys = torch.stack(ys)
    return {"r": r, "cond": cond, "worst": float((ys - ref).abs().max()),
            "outputs": ys}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    set_true_f32()
    x, w = inputs(dev)
    out = []
    for r in RS:
        row = sweep_r(x, w, r)
        print(f"r={r}: tolerates any {r} failures | hw cost "
              f"{(T + r) / T:.3f}x (vs {r + 1:.1f}x modular) | worst err "
              f"{row['worst']:.2e} | decode cond {row['cond']:.1e}")
        out.append(row)
    return out


if __name__ == "__main__":
    main()
