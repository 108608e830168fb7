"""The paper's coded-cost study (§5.2/§7), on the port.

  * runtime overhead of carrying parity: (T+r)/T FLOPs, constant in the
    device count, measured on the coded GEMM (``run``);
  * the offline encode cost (once per weight load: the encode kernel);
  * the decode (recovery) cost against the GEMM itself;
  * the study's kernels against their plain versions (``run_kernels``):
    the blocked GEMM and the r=1 decode.

  PYTHONPATH=src python -m repro_torch.launch.coded_overhead
  PYTHONPATH=src python -m repro_torch.launch.coded_overhead --device cpu

The rows and their keys are the reference study's
(``benchmarks/coded_overhead.py``), except that ``run_kernels`` reports
``us_kernel`` (the CUDA kernel) and ``us_plain`` (its plain PyTorch
version, called directly) for the reference's interpret/jnp columns.
Inputs come from a seeded ``torch.Generator`` on the device. Times are
microseconds per call, host clock around calls bracketed by
``torch.cuda.synchronize()``. The ``us_coded_recovering`` rows decode
shard 1 dead: at r=1 folded that is beyond the code's budget (it
tolerates no device failure), so those outputs are not a recovery, in
this package as in the reference.

Runs on the CUDA device unless ``--device cpu`` is given; without a card
and without that flag it raises. It writes nothing unless ``--out`` is
given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import (CodedDenseSpec, CodeSpec, coded_matmul,
                              make_parity_weights)
from repro_torch.device import resolve_device, set_true_f32
from repro_torch.kernels import ops, ref


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(f, *args, n: int = 20) -> float:
    """Microseconds per call of ``f(*args)`` over ``n`` calls after one
    warm-up, the device drained before and after."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    f(*args)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        f(*args)
    _sync(dev)
    return (time.perf_counter() - t0) / n * 1e6


@dataclasses.dataclass
class StudyCase:
    """One (T, r) point of ``run``: the inputs and the three GEMMs."""

    T: int
    r: int
    x: torch.Tensor
    w: torch.Tensor
    spec: CodedDenseSpec
    w_cdc: torch.Tensor
    valid: np.ndarray               # shard 1 dead

    def plain(self, x):
        return coded_matmul(x, self.w, None, self.spec)

    def coded(self, x):
        return coded_matmul(x, self.w, self.w_cdc, self.spec,
                            np.ones(self.T, bool))

    def recovering(self, x):
        return coded_matmul(x, self.w, self.w_cdc, self.spec, self.valid)


def study_cases(batch: int = 32, k: int = 2048, m: int = 4096,
                device="cuda"):
    """The sweep of ``run``, T in {4, 8, 16} x r in {1, 2} (folded)."""
    dev = torch.device(device)
    for T in (4, 8, 16):
        for r in (1, 2):
            gen = torch.Generator(device=dev).manual_seed(T * 10 + r)
            x = torch.randn((batch, k), generator=gen, device=dev)
            w = torch.randn((k, m), generator=gen, device=dev) / k ** 0.5
            spec = CodedDenseSpec(CodeSpec(T, r))
            valid = np.ones(T, bool)
            valid[1] = False
            yield StudyCase(T, r, x, w, spec, make_parity_weights(w, spec),
                            valid)


def run(batch: int = 32, k: int = 2048, m: int = 4096,
        device="cuda") -> list[dict]:
    rows = []
    for c in study_cases(batch, k, m, device):
        t_enc = _time(lambda w: make_parity_weights(w, c.spec), c.w, n=5)
        t_plain, t_coded, t_rec = (_time(c.plain, c.x), _time(c.coded, c.x),
                                   _time(c.recovering, c.x))
        rows.append({
            "T": c.T, "r": c.r,
            "flops_overhead_theory": round((c.T + c.r) / c.T, 3),
            "us_plain": round(t_plain, 1),
            "us_coded": round(t_coded, 1),
            "us_coded_recovering": round(t_rec, 1),
            "measured_overhead_x": round(t_coded / t_plain, 2),
            "us_encode_offline": round(t_enc, 1),
        })
    return rows


def run_kernels(device="cuda") -> list[dict]:
    """The study's kernels (the blocked GEMM, the r=1 decode) against
    their plain versions, at the reference's shapes."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    x = torch.randn((512, 512), generator=gen, device=dev)
    w = torch.randn((512, 512), generator=gen, device=dev)
    rows.append({"kernel": "matmul",
                 "us_kernel": round(_time(ops.matmul, x, w, n=3), 1),
                 "us_plain": round(_time(ref.matmul_ref, x, w, n=3), 1)})
    ys = torch.randn((8, 256, 512), generator=gen, device=dev)
    parity = ys.sum(0)
    valid = np.ones(8, bool)
    valid[3] = False
    vt = torch.as_tensor(valid, device=dev)
    rows.append({"kernel": "cdc_decode",
                 "us_kernel": round(_time(
                     lambda a, p: ops.cdc_decode(a, p, valid), ys, parity,
                     n=3), 1),
                 "us_plain": round(_time(
                     lambda a, p: ref.cdc_decode_ref(a, p, vt), ys, parity,
                     n=3), 1)})
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="also write the rows as JSON to this path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    set_true_f32()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}")
    res = {"device": name,
           "run": run(device=dev),
           "kernels": run_kernels(dev)}
    for row in res["run"] + res["kernels"]:
        print(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
