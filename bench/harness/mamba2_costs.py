"""Operations and bytes of one decode token's Mamba-2 state update
(``roofline_pct.mamba2_step``), counted from the configuration's widths
so that a change to the port cannot move them: each input byte read once
and each output byte written once."""
from __future__ import annotations


def step(cfg: dict, slots: int, itemsize: int = 4,
         state_itemsize: int = 4) -> tuple[float, float]:
    """(FLOPs, bytes) of one Mamba-2 layer's decode step over ``slots``
    rows: the SSM state [slots, H, P, N] and the conv window [slots, K-1,
    conv_dim] read once and written once (``state_itemsize``: float32),
    the step's inputs (the pre-conv x, B, C [slots, conv_dim] and the raw
    dt [slots, H]), its parameters (conv weight and bias, dt bias, A, D)
    and its output [slots, H * P] once. FLOPs: per state element the
    decay's multiply, the input's multiply-add and the readout's
    multiply-add; per channel the conv's K multiply-adds; D's
    multiply-add per output."""
    nh, hp = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
    n, g, k = cfg["ssm_state_size"], cfg["n_groups"], cfg["conv_kernel"]
    inner = nh * hp
    conv_dim = inner + 2 * g * n
    states = slots * nh * hp * n
    window = slots * (k - 1) * conv_dim
    flops = 5.0 * states + slots * (2.0 * k * conv_dim + 2.0 * inner)
    nbytes = 2 * state_itemsize * (states + window) + itemsize * (
        slots * (conv_dim + nh + inner) + (k + 1) * conv_dim + 3 * nh)
    return flops, float(nbytes)
