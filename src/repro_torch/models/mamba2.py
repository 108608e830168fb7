"""Mamba-2 mixer (SSD, Dao and Gu, arXiv:2405.21060 §§3-6): the ``M``
layers of a ``PatternConfig`` stack (Nemotron-H). Read per channel:

    (z, xBC, dt) = split(in_proj(x))
    xBC = silu(causal_conv1d(xBC) + b)
    (x, B, C) = split(xBC)
    dt = softplus(dt + dt_bias);  A = -exp(A_log)
    h = exp(dt·A)·h + dt·x ⊗ B[g];  y = h·C[g] + D·x
    out = out_proj(rmsnorm_group(y · silu(z)) · g)

with H heads of P channels, N states, G groups of B and C (head h reads
group h // (H / G)), and the gated norm over G groups of H·P / G
channels. ``in_proj`` is column-parallel, so coded in coded mode;
``out_proj`` is row-parallel and never coded (paper Table 1). The conv,
the dt bias, A and D are raw arrays, the norm gain ``norm.g``.

Two scans of the same recurrence: a prompt (``s > 1``, or no state: the
teacher-forced forward) runs the chunked SSD at ``cfg.mamba_chunk`` from
the given state (zeros without one), as in the paper's §6 (the intra-chunk
quadratic form, the chunk states, the recurrence across chunks, the state
read out into each chunk); one decode token (``step``) advances the
recurrence once. The state is {"conv": [B, K-1, conv_dim] (the last K-1
conv inputs, in the cache dtype), "ssm": [B, H, P, N] float32}; given a
state, the mixer writes both into the state's own tensors, so a captured
round reads and writes the same memory at every replay.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MAMBA2
from repro_torch.models.common import (Params, TPCtx, col_dense,
                                       linear_init, row_dense, softplus)
from repro_torch.models.mamba import _causal_conv


def mamba2_init(gen: torch.Generator, cfg, ctx: TPCtx, dtype,
                layers: tuple[int, ...] = (), device=None) -> Params:
    """Random params with optional leading stacked-layer dims, drawn as
    the published initialisation draws them: dt_bias the inverse softplus
    of dt ~ log-uniform in [1e-3, 1e-1], A_log = log U[1, 16], D = 1."""
    d, h, n_in = cfg.d_model, cfg.mamba_heads, cfg.mamba_inner
    cd = cfg.mamba_conv_dim

    def uniform(shape, lo, hi):
        u = torch.rand(layers + shape, generator=gen, device=device)
        return u.mul_(hi - lo).add_(lo)

    dt = torch.exp(uniform((h,), math.log(1e-3), math.log(1e-1)))
    conv_w = torch.randn(layers + (cfg.conv_kernel, cd), generator=gen,
                         device=device)
    conv_b = torch.randn(layers + (cd,), generator=gen, device=device)
    return {
        "in_proj": linear_init(gen, d, n_in + cd + h, ctx, dtype,
                               layers=layers, device=device),
        "conv_w": conv_w.mul_(cfg.conv_kernel ** -0.5).to(dtype),
        "conv_b": conv_b.mul_(0.1).to(dtype),
        "dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(dtype),
        "a_log": torch.log(uniform((h,), 1.0, 16.0)),
        "d_skip": torch.ones(layers + (h,), device=device),
        "norm": {"g": torch.ones(layers + (n_in,), device=device)},
        "out_proj": linear_init(gen, n_in, d, ctx, dtype,
                                scale=1.0 / n_in ** 0.5, coded=False,
                                layers=layers, device=device),
    }


def init_mamba2_state(cfg, batch: int, dtype=torch.float32, layers=(),
                      device=None) -> Params:
    """Zero state for ``batch`` rows (leading ``layers`` dims stacked): the
    conv window in ``dtype``, the SSM state in float32."""
    return {"conv": torch.zeros(layers + (batch, cfg.conv_kernel - 1,
                                          cfg.mamba_conv_dim),
                                dtype=dtype, device=device),
            "ssm": torch.zeros(layers + (batch, cfg.mamba_heads,
                                         cfg.mamba_head_dim, cfg.ssm_state),
                               dtype=torch.float32, device=device)}


def prefill_chunks(cfg, s: int) -> int:
    """The SSD chunks a prompt of ``s`` tokens takes through every Mamba-2
    layer of ``cfg`` (0 for a stack without one)."""
    kinds = getattr(cfg, "layer_kinds", "")
    return kinds.count(MAMBA2) * -(-s // cfg.mamba_chunk) if kinds else 0


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """[..., T] -> [..., T, T]: out[i, j] = x[j+1] + ... + x[i] for i >= j,
    -inf above the diagonal; summed from the terms (no difference of two
    cumulative sums, which would cancel)."""
    t = x.shape[-1]
    ones = torch.ones(t, t, dtype=torch.bool, device=x.device)
    xx = x[..., None].expand(*x.shape, t)
    xx = xx.masked_fill(~torch.tril(ones, -1), 0.0)
    out = torch.cumsum(xx, dim=-2)
    return out.masked_fill(~torch.tril(ones), float("-inf"))


def ssd(x, dt, a, bm, cm, chunk: int, h0=None):
    """The chunked SSD scan. x: [b, s, H, P]; dt: [b, s, H] (after the
    softplus); a: [H] (A, negative); bm, cm: [b, s, G, N]; h0: [b, H, P, N]
    or None (zeros). All float32. Returns (y [b, s, H, P] without the D
    skip, the final state [b, H, P, N]). The tail is padded with dt = 0,
    which leaves the state as it is."""
    b, s, nh, p = x.shape
    g, n = bm.shape[-2:]
    r = nh // g
    pad = -s % chunk
    if pad:
        x, bm, cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, bm, cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    c = (s + pad) // chunk
    xdt = (x * dt[..., None]).view(b, c, chunk, g, r, p)
    da = (dt * a).view(b, c, chunk, g, r).permute(0, 3, 4, 1, 2)
    cum = torch.cumsum(da, dim=-1)                         # [b, g, r, c, l]
    bm = bm.view(b, c, chunk, g, n)
    cm = cm.view(b, c, chunk, g, n)
    # 1. inside each chunk: y_l = sum_{s <= l} C_l.B_s decay(s -> l) xdt_s
    cb = torch.einsum("bclgn,bcsgn->bgcls", cm, bm)        # [b, g, c, l, s]
    decay = torch.exp(_segsum(da))                         # [b, g, r, c, l, s]
    y = torch.einsum("bgrcls,bcsgrp->bclgrp", cb[:, :, None] * decay, xdt)
    # 2. each chunk's own state from its inputs
    to_end = torch.exp(cum[..., -1:] - cum)                # [b, g, r, c, l]
    xe = xdt * to_end.permute(0, 3, 4, 1, 2)[..., None]
    states = torch.einsum("bcsgn,bcsgrp->bcgrpn", bm, xe)
    # 3. across chunks, from the given state
    start = torch.zeros((b, 1, g, r, p, n), dtype=x.dtype, device=x.device) \
        if h0 is None else h0.reshape(b, 1, g, r, p, n).to(x.dtype)
    states = torch.cat([start, states], dim=1)             # [b, c+1, ...]
    across = torch.exp(_segsum(F.pad(cum[..., -1], (1, 0))))
    states = torch.einsum("bgrzc,bcgrpn->bzgrpn", across, states)
    final = states[:, -1]
    # 4. the state at each chunk's start, read out into the chunk
    y = y + torch.einsum("bclgn,bcgrpn->bclgrp", cm, states[:, :-1]) \
        * torch.exp(cum).permute(0, 3, 4, 1, 2)[..., None]
    return y.reshape(b, c * chunk, nh, p)[:, :s], final.reshape(b, nh, p, n)


def step(p: Params, cfg, xbc: torch.Tensor, dt: torch.Tensor,
         state: Params) -> torch.Tensor:
    """One decode token's state update. xbc: [B, conv_dim] (before the
    conv); dt: [B, H] (before the softplus). Writes the conv window and
    the SSM state in place; returns y [B, H·P] (with the D skip, before
    the gate)."""
    b = xbc.shape[0]
    nh, hp, g, n = (cfg.mamba_heads, cfg.mamba_head_dim, cfg.mamba_groups,
                    cfg.ssm_state)
    conv = state["conv"]
    xc, window = _causal_conv(xbc[:, None].to(conv.dtype), p["conv_w"],
                              p["conv_b"], conv)
    conv.copy_(window)
    xc = F.silu(xc[:, 0].to(torch.float32))
    xs, bm, cm = xc.split([cfg.mamba_inner, g * n, g * n], dim=-1)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])      # [B, H]
    decay = torch.exp(dt * -torch.exp(p["a_log"]))
    h = state["ssm"]                                        # [B, H, P, N]
    hg = h.view(b, g, nh // g, hp, n)
    h.mul_(decay[..., None, None])
    hg.addcmul_((dt[..., None] * xs.view(b, nh, hp)).view(
        b, g, nh // g, hp, 1), bm.view(b, g, 1, 1, n))
    y = torch.matmul(hg.view(b, g, -1, n), cm.view(b, g, n, 1))
    y = y.view(b, nh, hp) + p["d_skip"][:, None] * xs.view(b, nh, hp)
    return y.view(b, nh * hp)


def _gated_norm(y, z, g, groups: int, eps: float):
    """rmsnorm over ``groups`` groups of channels of y·silu(z), times g."""
    y = y * F.silu(z.to(torch.float32))
    yg = y.view(*y.shape[:-1], groups, -1)
    yg = yg * torch.rsqrt(yg.square().mean(-1, keepdim=True) + eps)
    return yg.view(y.shape) * g


def mamba2(ctx: TPCtx, p: Params, cfg, x: torch.Tensor, valid=None,
           state: Params | None = None) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]; ``state`` (one layer's) is advanced in
    place."""
    b, s, _ = x.shape
    nh, hp, g, n = (cfg.mamba_heads, cfg.mamba_head_dim, cfg.mamba_groups,
                    cfg.ssm_state)
    n_in, cd = cfg.mamba_inner, cfg.mamba_conv_dim
    zxbcdt = col_dense(ctx, p["in_proj"], x, n_in + cd + nh, valid)
    z, xbc, dt = zxbcdt.split([n_in, cd, nh], dim=-1)
    if s == 1 and state is not None:
        y = step(p, cfg, xbc[:, 0], dt[:, 0], state)[:, None]
    else:
        conv = None if state is None else state["conv"]
        xc, window = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv)
        xc = F.silu(xc.to(torch.float32))
        xs, bm, cm = xc.split([n_in, g * n, g * n], dim=-1)
        dt = softplus(dt.to(torch.float32) + p["dt_bias"])
        xs = xs.reshape(b, s, nh, hp)
        y, final = ssd(xs, dt, -torch.exp(p["a_log"]),
                       bm.reshape(b, s, g, n), cm.reshape(b, s, g, n),
                       cfg.mamba_chunk,
                       None if state is None else state["ssm"])
        y = (y + p["d_skip"][:, None] * xs).reshape(b, s, n_in)
        if state is not None:
            state["conv"].copy_(window)
            state["ssm"].copy_(final)
    y = _gated_norm(y, z, p["norm"]["g"], g, cfg.norm_eps).to(x.dtype)
    return row_dense(ctx, p["out_proj"], y)
