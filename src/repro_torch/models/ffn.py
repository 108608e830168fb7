"""Dense FFN (SwiGLU / GELU). W1/W3 are column-parallel, so coded in coded
mode; W2 is row-parallel and never coded (paper Table 1)."""
from __future__ import annotations

import torch

from repro_torch.models.common import (Params, TPCtx, activation, col_dense,
                                       linear_init, row_dense)


def ffn_init(gen: torch.Generator, cfg, ctx: TPCtx, dtype,
             layers: tuple[int, ...] = (), device=None) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(layers=layers, device=device)
    p = {
        "w1": linear_init(gen, d, f, ctx, dtype, **kw),
        "w2": linear_init(gen, f, d, ctx, dtype, scale=1.0 / f ** 0.5,
                          coded=False, **kw),
    }
    if cfg.act == "silu":  # gated
        p["w3"] = linear_init(gen, d, f, ctx, dtype, **kw)
    return p


def ffn(ctx: TPCtx, p: Params, cfg, x: torch.Tensor, valid=None
        ) -> torch.Tensor:
    f = cfg.d_ff
    h = activation(cfg.act, col_dense(ctx, p["w1"], x, f, valid))
    if "w3" in p:
        h = h * col_dense(ctx, p["w3"], x, f, valid)
    return row_dense(ctx, p["w2"], h)
