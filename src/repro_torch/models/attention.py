"""Attention: GQA, RoPE, causal masks, the per-row KV ring cache.

The QKV projections are column-parallel, so coded in coded mode; Wo is
row-parallel and never coded. Attention is written as the reference writes
it — an einsum, a select of NEG_INF for masked scores, a softmax — not as
``scaled_dot_product_attention``, so masking and rounding follow the same
steps. Decode attends the whole cache in one chunk with grouped heads (the
expanded KV is never built); longer sequences stream KV chunks with an
online softmax.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import (Params, TPCtx, col_dense,
                                       linear_init, rope, row_dense)

NEG_INF = -1e30


def attn_dims(cfg, tp: int) -> tuple[int, int, int]:
    """(hq_run, hkv_run, group): head counts padded for the TP degree."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    hq_run = -(-hq // tp) * tp if tp > 1 else hq
    hkv_run = hkv
    while hq_run % hkv_run:
        hkv_run += 1
    return hq_run, hkv_run, hq_run // hkv_run


def attn_init(gen: torch.Generator, cfg, ctx: TPCtx, dtype,
              layers: tuple[int, ...] = (), device=None) -> Params:
    d, hd = cfg.d_model, cfg.hd
    hq_run, hkv_run, _ = attn_dims(cfg, ctx.tp)
    kw = dict(layers=layers, device=device)
    p = {
        "wq": linear_init(gen, d, hq_run * hd, ctx, dtype, **kw),
        "wk": linear_init(gen, d, hkv_run * hd, ctx, dtype, **kw),
        "wv": linear_init(gen, d, hkv_run * hd, ctx, dtype, **kw),
        "wo": linear_init(gen, hq_run * hd, d, ctx, dtype,
                          scale=1.0 / (hq_run * hd) ** 0.5, coded=False,
                          **kw),
    }
    if hq_run != cfg.n_heads or hkv_run != cfg.n_kv_heads:
        raise NotImplementedError(
            "padded attention heads (head counts not divisible by the TP "
            "degree) are not ported yet")
    return p


def _mask(q_pos, k_pos, kind: str, window: int) -> torch.Tensor:
    """q_pos [..., Sq], k_pos [..., Sk] -> bool [..., Sq, Sk] (True =
    attend). Negative k_pos marks an empty cache slot."""
    dq, dk = q_pos[..., :, None], k_pos[..., None, :]
    valid_slot = dk >= 0
    if kind == "bidir":
        return valid_slot & torch.ones_like(dq, dtype=torch.bool)
    m = (dk <= dq) & valid_slot
    if kind == "swa":
        m &= dk > dq - window
    return m


def _apply_mask(s, msk, n_head_dims: int):
    """Mask scores [B, <n_head_dims>, Sq, Sk] with msk [Sq, Sk] or
    [B, Sq, Sk]."""
    if msk.ndim == 2:
        idx = (None,) * (n_head_dims + 1)
    else:
        idx = (slice(None),) + (None,) * n_head_dims
    # a Python scalar, not a device tensor: no host-to-device copy, so the
    # round can be captured in a CUDA graph
    return torch.where(msk[idx], s, NEG_INF)


def _chunk_pos(pos, n: int, chunk: int):
    """[..., S] positions -> [n, ..., chunk]."""
    return pos.reshape(pos.shape[:-1] + (n, chunk)).movedim(-2, 0)


def _sdpa_chunked(q, k, v, q_pos, k_pos, *, kind: str, window: int,
                  kv_chunk: int, q_chunk: int, group: int) -> torch.Tensor:
    """Online-softmax attention. q: [B, Sq, H, hd]; k/v: [B, Sk, Hkv, hd]
    with H = group * Hkv; q_pos/k_pos: [Sq]/[Sk] or per-row [B, Sq]/[B, Sk].
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    scale = hd ** -0.5
    kv_chunk = min(kv_chunk, sk)
    single_chunk = kv_chunk >= sk
    if group > 1 and not single_chunk:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    q_chunk = min(q_chunk, sq)
    n_kv = -(-sk // kv_chunk)
    pad_k = n_kv * kv_chunk - sk
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad_k),
                                        value=-(10 ** 9))
    hk = k.shape[2]
    kc = k.reshape(b, n_kv, kv_chunk, hk, hd)
    vc = v.reshape(b, n_kv, kv_chunk, hk, hd)
    kpc = _chunk_pos(k_pos, n_kv, kv_chunk)

    def kv_attend(qi, qpi, ki, vi, kpi, carry=None):
        if carry is None and group > 1:
            # decode fast path, GQA grouped: the expanded KV never exists
            qg = qi.reshape(qi.shape[0], qi.shape[1], -1, group, hd)
            s = torch.einsum("bqkgd,bckd->bkgqc", qg, ki) * scale
            s = _apply_mask(s, _mask(qpi, kpi, kind, window), 2)
            pr = torch.softmax(s, dim=-1)
            o = torch.einsum("bkgqc,bckd->bqkgd", pr.to(vi.dtype), vi)
            return o.reshape(qi.shape)
        s = torch.einsum("bqhd,bchd->bhqc", qi, ki) * scale
        s = _apply_mask(s, _mask(qpi, kpi, kind, window), 1)
        if carry is None:
            p = torch.softmax(s, dim=-1)
            return torch.einsum("bhqc,bchd->bqhd", p.to(vi.dtype), vi)
        acc, m_run, l_run = carry
        m_new = torch.maximum(m_run, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_new = l_run * corr + p.sum(-1)
        pv = torch.einsum("bhqc,bchd->bhqd", p.to(vi.dtype), vi)
        return acc * corr[..., None] + pv, m_new, l_new

    def one_q_chunk(qi, qpi):
        if n_kv == 1:
            return kv_attend(qi, qpi, kc[:, 0], vc[:, 0], kpc[0])
        qc = qi.shape[1]
        carry = (torch.zeros((b, h, qc, hd), dtype=torch.float32,
                             device=q.device),
                 torch.full((b, h, qc), NEG_INF, dtype=torch.float32,
                            device=q.device),
                 torch.zeros((b, h, qc), dtype=torch.float32,
                             device=q.device))
        for i in range(n_kv):
            carry = kv_attend(qi, qpi, kc[:, i], vc[:, i], kpc[i], carry)
        acc, _, l_run = carry
        out = acc / torch.clamp(l_run[..., None], min=1e-30)
        return out.movedim(2, 1)                      # [B, qc, H, hd]

    n_q = -(-sq // q_chunk)
    pad_q = n_q * q_chunk - sq
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = torch.nn.functional.pad(q_pos, (0, pad_q))
    if n_q == 1:
        out = one_q_chunk(q, q_pos)
    else:
        qs = q.reshape(b, n_q, q_chunk, h, hd).movedim(1, 0)
        qps = _chunk_pos(q_pos, n_q, q_chunk)
        out = torch.stack([one_q_chunk(qs[i], qps[i]) for i in range(n_q)],
                          dim=1).reshape(b, n_q * q_chunk, h, hd)
    return out[:, :sq]


def _cache_update_per_row(cache, k, v, positions, s: int, C: int):
    """Ring-cache write when every row has its own length/positions.

    cache: {"k"/"v": [B, C, H, hd], "pos": [B, C], "len": [B]};
    positions: [B, s]. The write is IN PLACE into the cache tensors (the
    reference returns new arrays; the port updates the caller's state to
    avoid copying the cache every step). "len" is advanced by the caller.
    """
    kd, vd = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
    pd = positions.to(cache["pos"].dtype)
    if s >= C:
        kd, vd, pd = kd[:, -C:], vd[:, -C:], pd[:, -C:]
        offs = torch.arange(C, device=k.device) + (s - C)
    else:
        offs = torch.arange(s, device=k.device)
    slot = (cache["len"][:, None].long() + offs[None, :]) % C   # [B, s']
    bidx = torch.arange(cache["k"].shape[0], device=k.device)[:, None]
    cache["k"][bidx, slot] = kd
    cache["v"][bidx, slot] = vd
    cache["pos"][bidx, slot] = pd
    return cache["k"], cache["v"], cache["pos"]


def attention(ctx: TPCtx, p: Params, cfg, x: torch.Tensor, *, valid=None,
              cache: Params, pos_offset, q_chunk: int = 512,
              kv_chunk: int = 1024):
    """x: [B, S, D] -> [B, S, D], against the per-row cache of one layer
    ({"k","v": [B, C, Hkv, hd], "pos": [B, C], "len": [B]}), written in
    place; pos_offset: [B] lengths before this call."""
    b, s, d = x.shape
    hd = cfg.hd
    hq_run, hkv_run, group = attn_dims(cfg, ctx.tp)
    kind = "swa" if cfg.attn_kind == "swa" else "causal"
    q = col_dense(ctx, p["wq"], x, hq_run * hd, valid) \
        .reshape(b, s, hq_run, hd)
    positions = pos_offset[:, None] + torch.arange(s, device=x.device)
    k = col_dense(ctx, p["wk"], x, hkv_run * hd, valid) \
        .reshape(b, s, hkv_run, hd)
    v = col_dense(ctx, p["wv"], x, hkv_run * hd, valid) \
        .reshape(b, s, hkv_run, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    C = cache["k"].shape[1]
    k_cached, v_cached, cpos = _cache_update_per_row(cache, k, v, positions,
                                                     s, C)
    if s == 1:
        # decode: attend the whole cache as one chunk (grouped fast path)
        k, v, k_pos = k_cached, v_cached, cpos
        kv_chunk = max(kv_chunk, C)
    else:
        # prefill: the fresh K/V hold every cached token (the cache starts
        # empty), so attend over them with the streaming path
        k_pos = positions
    out = _sdpa_chunked(q, k, v, positions, k_pos, kind=kind,
                        window=cfg.window, kv_chunk=kv_chunk,
                        q_chunk=q_chunk, group=group)
    out = out.reshape(b, s, hq_run * hd).to(x.dtype)
    return row_dense(ctx, p["wo"], out)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.float32, tp: int = 1,
               layers: tuple[int, ...] = (), device=None) -> Params:
    """Per-row KV ring cache: every batch row has its own position vector
    and length, so rows decode at independent positions."""
    C = min(max_len, cfg.window) if cfg.attn_kind == "swa" else max_len
    _, hkv_run, _ = attn_dims(cfg, tp)
    hd = cfg.hd
    return {
        "k": torch.zeros(layers + (batch, C, hkv_run, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros(layers + (batch, C, hkv_run, hd), dtype=dtype,
                         device=device),
        "pos": torch.full(layers + (batch, C), -(10 ** 9),
                          dtype=torch.int32, device=device),
        "len": torch.zeros(layers + (batch,), dtype=torch.int32,
                           device=device),
    }
