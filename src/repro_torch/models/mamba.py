"""Selective-SSM (Mamba) branch: the port of the reference package's
``models/mamba.py``, used by hymba's parallel attention + mamba layers.

The heavy GEMMs are ordinary column/row-parallel layers, so CDC covers
``in_proj`` (column-parallel, coded) exactly like any output-split GEMM;
``wbc`` and ``out_proj`` are uncoded, and the conv, the dt projections and
the SSM parameters are raw arrays. The recurrence is a per-channel linear
scan, plain PyTorch here as it is plain JAX in the reference.

The state is {"conv": [B, K-1, di] (the last K-1 conv inputs, in the
cache dtype), "ssm": [B, di, n] (float32)}. Given a state, ``mamba``
writes the new conv window (``copy_`` out of a fresh concatenation) and
the new SSM state (in place) into that state's own tensors and returns
the same dict, so a captured round reads and writes the same memory at
every replay; without one (``forward``) it starts from zeros and returns
new tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (Params, TPCtx, col_dense,
                                       linear_init, row_dense, softplus)

CONV_K = 4
# passes a decode step makes over tensors of the SSM state's size [B, di,
# n]: dt * a written; exp read and written (decay); drive written; the
# update reads drive, decay and h and writes h; the readout reads h (what
# obs.perf counts of the state)
STEP_STATE_PASSES = 9


def mamba_init(gen: torch.Generator, cfg, ctx: TPCtx, dtype,
               layers: tuple[int, ...] = (), device=None) -> Params:
    """The reference's param tree, with optional leading stacked-layer
    dims."""
    d = cfg.d_model
    di = d  # branch width (parallel to attention in hymba)
    n = cfg.ssm_state
    dt_rank = max(d // 16, 1)
    kw = dict(layers=layers, device=device)

    def normal(shape, scale):
        return (torch.randn(layers + shape, generator=gen, device=device)
                * scale).to(dtype)

    a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": linear_init(gen, d, 2 * di, ctx, dtype, **kw),  # x, z
        "conv_w": normal((CONV_K, di), 0.5),
        "conv_b": torch.zeros(layers + (di,), dtype=dtype, device=device),
        "wbc": linear_init(gen, di, 2 * n, ctx, dtype, coded=False, **kw),
        "wdt1": normal((di, dt_rank), 1.0 / d ** 0.5),
        "wdt2": normal((dt_rank, di), 1.0 / dt_rank ** 0.5),
        "dt_bias": torch.zeros(layers + (di,), dtype=dtype, device=device),
        "a_log": torch.log(a).expand(layers + (di, n)).contiguous(),
        "d_skip": torch.ones(layers + (di,), device=device),
        "out_proj": linear_init(gen, di, d, ctx, dtype,
                                scale=1.0 / di ** 0.5, coded=False, **kw),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: [B, S, di]; w: [K, di]; state: [B, K-1,
    di]. Returns (y, the last K-1 inputs: a slice of a fresh tensor, never
    of ``state``)."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)               # [B, S+K-1, di]
    s = x.shape[1]
    y = xp[:, :s] * w[0]
    for i in range(1, k):                           # the reference's sum
        y = y + xp[:, i:i + s] * w[i]
    return y + b, xp[:, -(k - 1):]


def _scan(decay, drive, c, h):
    """The reference's ``chunked_time_scan`` of h <- decay_t * h + drive_t
    and y_t = h . c_t, as a plain loop over time: its chunking is
    activation checkpointing for the backward pass, and a plain loop gives
    the same carries and outputs. decay, drive: [B, S, di, n]; c: [B, S,
    n]; h: [B, di, n] float32, advanced in place. Returns y [B, S, di].

    Serving: each step's h lands in its row of ``hs`` [S, B, di, n] (one
    launch a step), and one product reads them all out; with one step,
    ``hs`` is a view of ``h`` itself, so a decode step moves no copy.
    Under autograd (grad mode, an input that requires grad) the steps are
    new tensors stacked once, since autograd refuses ``out=``; the layer's
    checkpoint (``common.remat_layer``) bounds what the backward keeps, as
    the reference's chunking does, and ``h`` takes the last carry outside
    the graph (no caller differentiates through the state)."""
    s = decay.shape[1]
    if torch.is_grad_enabled() and (decay.requires_grad
                                    or drive.requires_grad):
        steps, prev = [], h.clone()     # h itself is written below
        # one unbind a tensor: its backward stacks the steps' gradients
        # once, where slicing each step out would give each a zero-filled
        # gradient of the whole [B, S, di, n] to add up
        for dr, de in zip(drive.unbind(1), decay.unbind(1)):
            prev = torch.addcmul(dr, de, prev)
            steps.append(prev)
        with torch.no_grad():
            h.copy_(prev)
        return torch.einsum("sbdn,bsn->bsd", torch.stack(steps), c)
    hs = h[None] if s == 1 else decay.new_empty((s,) + h.shape)
    prev = h
    for t in range(s):
        prev = torch.addcmul(drive[:, t], decay[:, t], prev, out=hs[t])
    if s > 1:
        h.copy_(prev)
    return torch.einsum("sbdn,bsn->bsd", hs, c)


def mamba(ctx: TPCtx, p: Params, cfg, x: torch.Tensor, valid=None,
          state: Params | None = None):
    """x: [B, S, D] -> ([B, S, D], state)."""
    b, s, d = x.shape
    di = d
    n = cfg.ssm_state
    xz = col_dense(ctx, p["in_proj"], x, 2 * di, valid)
    xm, z = xz[..., :di], xz[..., di:]

    conv_state = state["conv"] if state is not None else None
    xm, new_conv = _causal_conv(xm, p["conv_w"], p["conv_b"], conv_state)
    xm = F.silu(xm)

    bc = xm @ p["wbc"]["w"][:, :2 * n]
    bmat, cmat = bc[..., :n], bc[..., n:]          # [B, S, n]
    dt = softplus((xm @ p["wdt1"]) @ p["wdt2"] + p["dt_bias"])  # [B, S, di]
    a = -torch.exp(p["a_log"])                     # [di, n]

    decay = torch.exp(dt.to(torch.float32)[..., None] * a)
    drive = (dt * xm).to(torch.float32)[..., None] \
        * bmat.to(torch.float32)[..., None, :]     # [B, S, di, n]

    if state is None:
        h = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
        new = {"conv": new_conv, "ssm": h}
    else:
        h = state["ssm"]
        state["conv"].copy_(new_conv)
        new = state
    y = _scan(decay, drive, cmat.to(torch.float32), h)
    y = (y + xm.to(torch.float32) * p["d_skip"]).to(x.dtype)
    y = y * F.silu(z)
    return row_dense(ctx, p["out_proj"], y), new


def init_mamba_state(cfg, batch: int, dtype=torch.float32, layers=(),
                     device=None) -> Params:
    """Zero state for ``batch`` rows (leading ``layers`` dims stacked):
    the conv window in ``dtype``, the SSM state in float32."""
    di, n = cfg.d_model, cfg.ssm_state
    return {"conv": torch.zeros(layers + (batch, CONV_K - 1, di),
                                dtype=dtype, device=device),
            "ssm": torch.zeros(layers + (batch, di, n), dtype=torch.float32,
                               device=device)}
