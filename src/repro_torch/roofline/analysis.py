"""Roofline terms of one NVIDIA H100 (SXM, NVIDIA's data sheet).

Two terms, in seconds, for the work of one round on one card:

  compute = FLOPs / peak FLOP/s     (float32 outside the tensor cores, or
                                     bf16 on them: the params' storage type)
  memory  = bytes / HBM bytes/s

and a collective term kept at zero: one card moves no bytes between
devices, so there is no collective parser here (the reference package
parses them out of compiled HLO). The rates assume the card's full power
limit of 700 W; a card set below it runs slower, so every measurement
against these bounds is reported with the card's power limit.
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
