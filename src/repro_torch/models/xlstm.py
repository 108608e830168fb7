"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory), the port
of the reference package's ``models/xlstm.py`` (arXiv:2405.04517), with
the same exponential gating and stabilizer math.

CDC covers the mLSTM's up/q/k/v projections and the sLSTM's gate
projection ``wx`` (column-parallel, coded); ``down`` is row-parallel and
uncoded; ``wif`` and the sLSTM's block-diagonal recurrence ``r`` are raw
arrays. The recurrences are plain PyTorch, as they are plain JAX in the
reference.

A block's state leads with the batch (slot) axis: the mLSTM's {"c": [B,
nh, dh, dh], "n": [B, nh, dh], "m": [B, nh]}, the sLSTM's {"h", "c",
"n", "m": [B, nh, dh]}. Given a state, a block writes its new state into
that state's own tensors and returns the same dict, so a captured round
reads and writes the same memory at every replay; without one
(``forward``) it starts from the reference's initial state and returns
new tensors. A prompt (s > 1) takes the chunkwise-parallel form, one
token (s = 1) the sequential step, as the reference branches: the two
forms agree only up to reassociation.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (Params, TPCtx, col_dense, layernorm,
                                       layernorm_init, linear_init,
                                       row_dense, softplus)

NEG_INF = -1e30       # the stabilizer's start, and a padded step's input gate


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """-softplus(-x), as the reference computes log-sigmoid."""
    return -softplus(-x)


def _write(state: Params | None, new: Params) -> Params:
    """``new`` copied into ``state``'s tensors (returned), or ``new``
    itself when there is no state to update."""
    if state is None:
        return new
    for key, val in new.items():
        state[key].copy_(val)
    return state


# ------------------------------------------------------------- mLSTM -------

def mlstm_init(gen: torch.Generator, cfg, ctx: TPCtx, dtype,
               device=None) -> Params:
    d = cfg.d_model
    du = 2 * d  # up-projection factor 2
    nh = cfg.n_heads

    def coded(k, m):
        return linear_init(gen, k, m, ctx, dtype, device=device)

    up = coded(d, 2 * du)                 # x_m and the gate z
    wq, wk, wv = coded(du, du), coded(du, du), coded(du, du)
    wif = torch.randn((du, 2 * nh), generator=gen, device=device) / du ** 0.5
    down = linear_init(gen, du, d, ctx, dtype, scale=1.0 / du ** 0.5,
                       coded=False, device=device)
    return {"norm": layernorm_init(d, device=device), "up": up, "wq": wq,
            "wk": wk, "wv": wv, "wif": wif.to(dtype),
            "b_if": torch.zeros(2 * nh, device=device), "down": down}


def _mlstm_chunkwise(q, k, v, i_raw, f_log, c0, n0, m0, chunk: int = 128):
    """Chunkwise-parallel mLSTM: within a chunk of W steps, causal
    attention-like products with decay weights exp(g_tau - M_t); across
    chunks, C carried once per boundary. Stabilized with M_t = max(m0,
    cummax g), so every exponent is <= 0. Padded steps take i = -1e30 (no
    write) and f = 0 (keep the state).

    q, k, v: [B, S, nh, dh]; gates [B, S, nh]. Returns (h [B, S, nh, dh],
    (C, n, m) at the end)."""
    b, s, nh, dh = q.shape
    w = min(chunk, s)
    if s % w:
        pad = w - s % w
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        i_raw = F.pad(i_raw, (0, 0, 0, pad), value=NEG_INF)
        f_log = F.pad(f_log, (0, 0, 0, pad))
    n_chunks = q.shape[1] // w

    def to_chunks(a):
        return a.reshape((b, n_chunks, w) + a.shape[2:]).movedim(1, 0)

    xs = tuple(map(to_chunks, (q, k, v, i_raw, f_log)))
    causal = torch.ones((w, w), dtype=torch.bool, device=q.device).tril()
    c, n, m = c0, n0, m0          # [B,nh,dh,dh], [B,nh,dh], [B,nh]
    hs = []
    for qi, ki, vi, ii, fi in zip(*xs):   # [B,w,nh,dh] x3, [B,w,nh] x2
        cum_f = torch.cumsum(fi, dim=1)                    # [B,w,nh]
        g = ii - cum_f
        big_m = torch.maximum(torch.cummax(g, dim=1).values, m[:, None])
        scores = torch.einsum("bthd,bchd->bhtc", qi, ki)
        # the exponent is <= 0 on and below the diagonal; above it (tau >
        # t, never read) it can pass float32's range, and the reference's
        # exp there is inf, whose product with the masked zero gradient
        # makes its backward NaN. Masked first, those entries are exp(-inf)
        # = 0: the same values, and a gradient equal to the reference's
        # wherever the reference's is finite
        decay = torch.exp(torch.where(
            causal, g.movedim(1, 2)[:, :, None, :]
            - big_m.movedim(1, 2)[:, :, :, None], float("-inf")))
        a = torch.where(causal, scores * decay, 0.0)
        inter = torch.exp(m[:, None] - big_m)               # [B,w,nh]
        num = torch.einsum("bhij,bthj->bthi", c, qi) * inter[..., None] \
            + torch.einsum("bhtc,bchd->bthd", a, vi)
        den = torch.einsum("bhj,bthj->bth", n, qi) * inter \
            + a.sum(-1).transpose(1, 2)
        hs.append(num / torch.clamp(den.abs(), min=1.0)[..., None])
        # chunk-end state
        w_end = torch.exp(g - big_m[:, -1:, :])             # [B,w,nh]
        keep = torch.exp(m - big_m[:, -1])                  # [B,nh]
        c = c * keep[..., None, None] \
            + torch.einsum("bchd,bche,bch->bhde", vi, ki, w_end)
        n = n * keep[..., None] + torch.einsum("bche,bch->bhe", ki, w_end)
        # m_W = F_W + M_W where M_W = max(m0, max_tau g_tau)
        m = cum_f[:, -1] + torch.maximum(g.max(dim=1).values, m)
    h = torch.cat(hs, dim=1)[:, :s]
    return h, (c, n, m)


def _mlstm_step(state: Params, q, k, v, i, f) -> torch.Tensor:
    """One sequential step on ``state`` in place; q, k, v: [B, nh, dh],
    gates [B, nh]. Returns h [B, nh, dh]. The matrix memory is scaled
    and given its rank-1 write in place (read and written twice), then
    read once more for the readout."""
    c, n, m = state["c"], state["n"], state["m"]
    m_new = torch.maximum(f + m, i)
    i_g = torch.exp(i - m_new)[..., None]
    f_g = torch.exp(f + m - m_new)[..., None]
    c.mul_(f_g[..., None]).addcmul_((i_g * v)[..., :, None],
                                    k[..., None, :])
    n.mul_(f_g).add_(i_g * k)
    m.copy_(m_new)
    num = torch.einsum("bhij,bhj->bhi", c, q)
    den = torch.clamp(torch.einsum("bhj,bhj->bh", n, q).abs(), min=1.0)
    return num / den[..., None]


def mlstm(ctx: TPCtx, p: Params, cfg, x: torch.Tensor, valid=None,
          state: Params | None = None):
    """x: [B, S, D] -> ([B, S, D], state). Matrix memory C: [B, nh, dh,
    dh]."""
    b, s, d = x.shape
    du = 2 * d
    nh = cfg.n_heads
    dh = du // nh
    xn = layernorm(p["norm"], x, cfg.norm_eps)
    up = col_dense(ctx, p["up"], xn, 2 * du, valid)
    xm, z = up[..., :du], up[..., du:]

    q = col_dense(ctx, p["wq"], xm, du, valid).reshape(b, s, nh, dh)
    k = col_dense(ctx, p["wk"], xm, du, valid).reshape(b, s, nh, dh) \
        / dh ** 0.5
    v = col_dense(ctx, p["wv"], xm, du, valid).reshape(b, s, nh, dh)
    q, k, v = (a.to(torch.float32) for a in (q, k, v))

    gates = (xm @ p["wif"]).to(torch.float32) + p["b_if"]  # [B, S, 2nh]
    i_raw, f_log = gates[..., :nh], _log_sigmoid(gates[..., nh:])

    if s > 1:  # chunkwise-parallel form
        st = state if state is not None \
            else init_mlstm_state(cfg, b, x.device)
        h4, (c, n, m) = _mlstm_chunkwise(q, k, v, i_raw, f_log, st["c"],
                                         st["n"], st["m"])
        new = _write(state, {"c": c, "n": n, "m": m})
    else:      # decode: one sequential step
        new = state if state is not None \
            else init_mlstm_state(cfg, b, x.device)
        h4 = _mlstm_step(new, q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0],
                         f_log[:, 0])
    h = h4.reshape(b, s, du).to(x.dtype) * F.silu(z)
    return x + row_dense(ctx, p["down"], h), new


def init_mlstm_state(cfg, batch: int, device=None) -> Params:
    du = 2 * cfg.d_model
    nh = cfg.n_heads
    dh = du // nh
    return {"c": torch.zeros((batch, nh, dh, dh), device=device),
            "n": torch.zeros((batch, nh, dh), device=device),
            "m": torch.full((batch, nh), NEG_INF, device=device)}


# ------------------------------------------------------------- sLSTM -------

def slstm_init(gen: torch.Generator, cfg, ctx: TPCtx, dtype,
               device=None) -> Params:
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    wx = linear_init(gen, d, 4 * d, ctx, dtype, device=device)  # z, i, f, o
    r = torch.randn((nh, dh, 4 * dh), generator=gen, device=device) \
        / dh ** 0.5                                   # block-diag recurrence
    down = linear_init(gen, d, d, ctx, dtype, scale=1.0 / d ** 0.5,
                       coded=False, device=device)
    return {"norm": layernorm_init(d, device=device), "wx": wx,
            "r": r.to(dtype), "bias": torch.zeros(4 * d, device=device),
            "down": down}


def slstm(ctx: TPCtx, p: Params, cfg, x: torch.Tensor, valid=None,
          state: Params | None = None):
    """Strictly recurrent scalar LSTM with exponential gating; a plain
    loop over time (the reference's ``chunked_time_scan`` checkpoints for
    the backward pass; here the block's checkpoint, ``remat_layer``, does
    that in training)."""
    b, s, d = x.shape
    nh = cfg.n_heads
    dh = d // nh
    xn = layernorm(p["norm"], x, cfg.norm_eps)
    wx = col_dense(ctx, p["wx"], xn, 4 * d, valid)  # [B, S, 4D]

    st = state if state is not None else init_slstm_state(cfg, b, x.device)
    h, c, n, m = st["h"], st["c"], st["n"], st["m"]
    r = p["r"].to(torch.float32)
    # the reference adds the bias as [nh, 4dh] (it is not regrouped)
    bias = p["bias"].reshape(nh, 4 * dh)
    # regroup wx so each head's 4 gates are contiguous: [B, S, nh, 4dh]
    wxs = wx.reshape(b, s, 4, nh, dh).movedim(2, 3).reshape(b, s, nh, 4 * dh)
    hs = []
    # one unbind (not a slice a step): under autograd its backward stacks
    # the steps' gradients once
    for wxt in wxs.unbind(1):
        rec = torch.einsum("bhi,hij->bhj", h, r)   # [B, nh, 4dh]
        pre = wxt.to(torch.float32) + rec + bias
        zt, it, ft, ot = pre.split(dh, dim=-1)
        zt = torch.tanh(zt)
        ot = torch.sigmoid(ot)
        f_log = _log_sigmoid(ft)
        m_new = torch.maximum(f_log + m, it)
        i_g = torch.exp(it - m_new)
        f_g = torch.exp(f_log + m - m_new)
        c = f_g * c + i_g * zt
        n = f_g * n + i_g
        h = ot * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    new = _write(state, {"h": h, "c": c, "n": n, "m": m})
    return x + row_dense(ctx, p["down"], y), new


def init_slstm_state(cfg, batch: int, device=None) -> Params:
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    shape = (batch, nh, dh)
    return {"h": torch.zeros(shape, device=device),
            "c": torch.zeros(shape, device=device),
            "n": torch.ones(shape, device=device),
            "m": torch.zeros(shape, device=device)}


class Block(NamedTuple):
    """One block kind's param init, forward and initial decode state."""
    init: Callable
    apply: Callable
    state: Callable


BLOCKS = {"mlstm": Block(mlstm_init, mlstm, init_mlstm_state),
          "slstm": Block(slstm_init, slstm, init_slstm_state)}
