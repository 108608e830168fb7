"""Roofline terms of one NVIDIA H100 (SXM, NVIDIA's data sheet).

Three terms, in seconds, for the work of one round or step on one card:

  compute    = FLOPs / peak FLOP/s    (float32 outside the tensor cores,
                                       or bf16 on them: the params'
                                       storage type)
  memory     = bytes / HBM bytes/s
  collective = wire bytes / NVLink bytes/s

A served round on one card moves no bytes between devices, so its
collective term is zero. Where the port's path sends messages (the mesh
trainer's, reckoned by ``train.trainer.mesh_step_messages``),
``wire_bytes`` turns them into wire bytes with the reference's ring model
(``src/repro/roofline/analysis.py``, which reads the same collectives out
of compiled HLO; the port compiles none):

  all-gather:         bytes * (k-1)/k   (bytes: the gathered result)
  all-reduce:         2 * bytes * (k-1)/k
  reduce-scatter:     bytes * (k-1)     (bytes: the scattered result)
  all-to-all:         bytes * (k-1)/k
  collective-permute: bytes

The rates are the H100 SXM data sheet's at the card's full power limit of
700 W; a card set below it runs slower, so every measurement against
these bounds is reported with the card's power limit.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS = 67e12              # float32 outside the tensor cores (TF32 off:
#                                device.set_true_f32)
BF16_FLOPS = 989e12            # bf16 tensor cores, dense
NVLINK_BYTES_PER_S = 450e9     # NVLink, each way per card

HW = {"peak_flops": F32_FLOPS, "hbm_bw": HBM_BYTES_PER_S,
      "link_bw": NVLINK_BYTES_PER_S}


def hw_for(dtype: torch.dtype) -> dict:
    """The card's rates for params stored in ``dtype``: the bf16 tensor-core
    peak for bf16 storage, the float32 peak otherwise."""
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    return dict(HW, peak_flops=peak)


def roofline_terms(cost: dict, coll: dict | None = None, hw: dict = HW
                   ) -> dict:
    """Compute, memory and collective times of ``cost`` ({"flops",
    "bytes accessed"}), the dominant one, and the bound: the largest."""
    flops = float(cost.get("flops", 0.0))
    bytes_ = float(cost.get("bytes accessed", 0.0))
    wire = float((coll or {}).get("total", 0.0))
    t_c = flops / hw["peak_flops"]
    t_m = bytes_ / hw["hbm_bw"]
    t_x = wire / hw["link_bw"]
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])[0]
    return {
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
        "dominant": dom, "bound_step_s": max(t_c, t_m, t_x),
        "flops": flops, "bytes": bytes_, "wire_bytes": wire,
    }


COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


def wire_bytes(messages) -> dict:
    """Ring-model wire bytes by collective kind of ``messages``, an
    iterable of (kind, bytes, group size), as the reference's
    ``collective_bytes`` gives them for the same collectives in HLO:
    {kind: bytes, ..., "total": bytes, "counts": {kind: messages}}."""
    out: dict = dict.fromkeys(COLLECTIVE_KINDS, 0.0)
    counts = dict.fromkeys(COLLECTIVE_KINDS, 0)
    for kind, nbytes, k in messages:
        k = max(int(k), 2)
        if kind == "all-gather":
            wire = nbytes * (k - 1) / k
        elif kind == "all-reduce":
            wire = 2 * nbytes * (k - 1) / k
        elif kind == "reduce-scatter":
            wire = nbytes * (k - 1)
        elif kind == "all-to-all":
            wire = nbytes * (k - 1) / k
        elif kind == "collective-permute":
            wire = nbytes
        else:
            raise ValueError(f"unknown collective {kind!r}")
        out[kind] += wire
        counts[kind] += 1
    out["total"] = sum(out.values())
    out["counts"] = counts
    return out


def roofline_report(terms: dict, model_flops_per_device: float,
                    hw: dict = HW) -> dict:
    """``terms`` (``roofline_terms``) with the usefulness ratio MODEL_FLOPS
    / counted FLOPs and the roofline fraction: the time the useful FLOPs
    take at ``hw``'s peak over the bound."""
    flops = terms["flops"]
    useful = model_flops_per_device / flops if flops else 0.0
    t_useful = model_flops_per_device / hw["peak_flops"]
    bound = terms["bound_step_s"]
    frac = t_useful / bound if bound else 0.0
    return dict(terms, model_flops=model_flops_per_device,
                useful_ratio=useful, roofline_fraction=frac)
