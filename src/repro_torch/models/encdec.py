"""Whisper-style encoder-decoder: init, encode, forward, decode state, decode
step.

The audio frontend is a stub, as in the reference: a request carries
precomputed frame embeddings [B, enc_seq, d_model]. The encoder is
bidirectional attention blocks (LayerNorm, GELU FFN); the decoder has
causal self-attention over the per-row KV cache and cross-attention over
the encoder output. Every QKV and FFN-up projection is column-parallel, so
coded under CDC, the encoder's and the cross K/V's included.

The decode state is the slot-batched layout: the per-row self-attention
cache plus the per-row cross-attention bank, K and V [L, B, Se, Hkv, hd]
and positions [L, B, Se], computed once per request by ``init_decode_state``
(the encoder and each layer's cross K/V). The K/V of the cache and the
bank are stored heads-major ([L, B, Hkv, S, hd], seen through a
transposed view), so that each layer's attention multiplies them in place
and a round reads the bank and the cache once. Layer weights are stacked
[L, ...]; the reference's layer ``scan`` is a Python loop over views.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import (Params, TPCtx, col_dense,
                                       layernorm, layernorm_init,
                                       linear_init, remat_layer,
                                       sinusoidal_pos, tree_index,
                                       tree_unstack)

# decode positions index a table of at least this many rows and wrap
# beyond it, as the reference does
POS_TABLE = 8192


def init_params(cfg, gen: torch.Generator, ctx: TPCtx, dtype=torch.float32,
                device=None) -> Params:
    """Random parameters drawn from ``gen`` on ``device``, in the
    reference's layout (``enc_layers`` and ``dec_layers`` stacked)."""
    d = cfg.d_model
    enc, dec = (cfg.encoder_layers,), (cfg.n_layers,)
    vocab_pad = ctx.pad_dim(cfg.vocab)
    embed = torch.randn((vocab_pad, d), generator=gen, device=device)
    attn = functools.partial(attn_mod.attn_init, gen, cfg, ctx, dtype,
                             device=device)
    ffn = functools.partial(ffn_mod.ffn_init, gen, cfg, ctx, dtype,
                            device=device)
    return {
        "embed": embed.mul_(0.02).to(dtype),
        "lm_head": linear_init(gen, d, cfg.vocab, ctx, dtype,
                               scale=1.0 / d ** 0.5, device=device),
        "enc_layers": {
            "ln1": layernorm_init(d, enc, device), "attn": attn(layers=enc),
            "ln2": layernorm_init(d, enc, device), "ffn": ffn(layers=enc),
        },
        "enc_ln_f": layernorm_init(d, device=device),
        "dec_layers": {
            "ln1": layernorm_init(d, dec, device), "self": attn(layers=dec),
            "ln_x": layernorm_init(d, dec, device), "cross": attn(layers=dec),
            "ln2": layernorm_init(d, dec, device), "ffn": ffn(layers=dec),
        },
        "dec_ln_f": layernorm_init(d, device=device),
    }


def encode(cfg, params: Params, ctx: TPCtx, frames: torch.Tensor,
           valid=None, *, remat: str = "full") -> torch.Tensor:
    """frames [B, Se, D] (precomputed embeddings) -> encoder output. Under
    grad mode each layer is checkpointed unless ``remat`` is "none" (the
    reference checkpoints its enc-dec layers whole)."""
    eps = cfg.norm_eps
    x = frames + sinusoidal_pos(frames.shape[1], cfg.d_model, frames.dtype,
                                frames.device)[None]

    def body(x, p):
        x = x + attn_mod.attention(ctx, p["attn"], cfg,
                                   layernorm(p["ln1"], x, eps), valid=valid,
                                   kind="bidir")
        return x + ffn_mod.ffn(ctx, p["ffn"], cfg,
                               layernorm(p["ln2"], x, eps), valid)

    body = remat_layer(body, "none" if remat == "none" else "full")
    for p in tree_unstack(params["enc_layers"], cfg.encoder_layers):
        x = body(x, p)
    return layernorm(params["enc_ln_f"], x, eps)


def _dec_layer(cfg, ctx, p, x, valid, cache, xkv, pos, q_chunk, kv_chunk):
    eps = cfg.norm_eps
    x = x + attn_mod.attention(
        ctx, p["self"], cfg, layernorm(p["ln1"], x, eps), valid=valid,
        cache=cache, pos_offset=pos, kind="causal", q_chunk=q_chunk,
        kv_chunk=kv_chunk)
    x = x + attn_mod.attention(
        ctx, p["cross"], cfg, layernorm(p["ln_x"], x, eps), valid=valid,
        kind="bidir", kv_override=xkv, q_chunk=q_chunk, kv_chunk=kv_chunk)
    return x + ffn_mod.ffn(ctx, p["ffn"], cfg, layernorm(p["ln2"], x, eps),
                           valid)


def forward(cfg, params: Params, ctx: TPCtx, tokens: torch.Tensor,
            frames: torch.Tensor, valid=None, *, remat: str = "full",
            q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """Teacher-forced logits [B, S, vocab] (float32). tokens: [B, S];
    frames: [B, Se, D]. ``remat`` as in ``encode``."""
    enc = encode(cfg, params, ctx, frames, valid, remat=remat)
    x = params["embed"][tokens.long()]
    x = x + sinusoidal_pos(tokens.shape[1], cfg.d_model, x.dtype,
                           x.device)[None]

    def body(x, p):
        xkv = attn_mod.cross_kv(ctx, p["cross"], cfg, enc, valid)
        return _dec_layer(cfg, ctx, p, x, valid, None, xkv, 0, q_chunk,
                          kv_chunk)

    body = remat_layer(body, "none" if remat == "none" else "full")
    for p in tree_unstack(params["dec_layers"], cfg.n_layers):
        x = body(x, p)
    x = layernorm(params["dec_ln_f"], x, cfg.norm_eps)
    logits = col_dense(ctx, params["lm_head"], x, cfg.vocab, valid)
    return logits.to(torch.float32)


def empty_decode_state(cfg, ctx: TPCtx, batch: int, max_len: int,
                       dtype=torch.float32, device=None) -> Params:
    """The decode state's tensors, allocated and not computed: the
    per-row self-attention cache (empty) and a zero cross-attention bank
    {"k","v": [L, B, Se, Hkv, hd], "pos": [L, B, Se]}; K and V of both
    stored heads-major (``attention.heads_major``)."""
    L, se, hd = cfg.n_layers, cfg.enc_seq, cfg.hd
    _, hkv_run, _ = attn_mod.attn_dims(cfg, ctx.tp)
    kv = attn_mod.init_cache(cfg, batch, max_len, dtype, tp=ctx.tp,
                             layers=(L,), device=device)
    bank = (L, batch, se, hkv_run, hd)
    return {"kv": kv,
            "xkv": {"k": attn_mod.heads_major(bank, dtype, device),
                    "v": attn_mod.heads_major(bank, dtype, device),
                    "pos": torch.zeros((L, batch, se), dtype=torch.int32,
                                       device=device)}}


def init_decode_state(cfg, ctx: TPCtx, params: Params, frames: torch.Tensor,
                      batch: int, max_len: int, dtype=torch.float32,
                      valid=None) -> Params:
    """Run the encoder once over ``frames`` [B, Se, D] and fill each
    layer's cross-attention bank with its K/V (cast to the cache dtype)
    and per-row positions; the self-attention cache starts empty."""
    state = empty_decode_state(cfg, ctx, batch, max_len, dtype,
                               frames.device)
    enc = encode(cfg, params, ctx, frames, valid)
    xkv = state["xkv"]
    for i in range(cfg.n_layers):
        p = tree_index(params["dec_layers"], i)
        k, v, kp = attn_mod.cross_kv(ctx, p["cross"], cfg, enc, valid)
        xkv["k"][i].copy_(k)
        xkv["v"][i].copy_(v)
        xkv["pos"][i].copy_(kp.expand(batch, -1))
    return state


@functools.lru_cache(maxsize=None)
def _pos_table(tab: int, d: int, dtype, device) -> torch.Tensor:
    """The decoder's position table, built once per (rows, width, dtype,
    device): a round gathers its rows and never rebuilds it (a captured
    round keeps its address)."""
    return sinusoidal_pos(tab, d, dtype, device)


def decode_step(cfg, params: Params, ctx: TPCtx, state: Params,
                tokens: torch.Tensor, valid=None, *, kv_chunk: int = 1024,
                last_only: bool = False, return_hidden: bool = False):
    """tokens: [B, s] -> (logits [B, s, V] f32, state); the self-attention
    cache in ``state`` is updated in place, the bank only read.

    last_only: logits for the final position only. return_hidden: skip
    the LM head and return the post-dec_ln_f hidden states (the fused
    round feeds them to the fused head kernel)."""
    x = params["embed"][tokens.long()]
    kv, xkv = state["kv"], state["xkv"]
    s = tokens.shape[1]
    pos = kv["len"][0].clone()          # [B]; the same for every layer
    tab = max(POS_TABLE, s)
    pe = _pos_table(tab, cfg.d_model, x.dtype, x.device)
    steps = torch.arange(s, device=x.device)
    x = x + pe[(pos[:, None].long() + steps) % tab]
    for i in range(cfg.n_layers):
        cache = {name: kv[name][i] for name in ("k", "v", "pos", "len")}
        bank = (xkv["k"][i], xkv["v"][i], xkv["pos"][i])
        x = _dec_layer(cfg, ctx, tree_index(params["dec_layers"], i), x,
                       valid, cache, bank, pos, s, kv_chunk)
    kv["len"] += s
    if last_only:
        x = x[:, -1:]
    x = layernorm(params["dec_ln_f"], x, cfg.norm_eps)
    if return_hidden:
        return x, state
    logits = col_dense(ctx, params["lm_head"], x, cfg.vocab, valid)
    return logits.to(torch.float32), state
