"""Decoder-only LM (dense body, mixture of experts, hybrid attention +
mamba, a layer-pattern stack, or xLSTM): init, forward, decode state,
decode step.

Layer weights are stacked on a leading [L, ...] axis as in the reference;
the reference's layer ``scan`` is a Python loop over that axis here, each
layer reading views of its slice. A hybrid layer (hymba) runs SWA
attention and a mamba branch on the same normed input and averages them,
``(a + m) * 0.5``, before the residual; its decode state adds
``state["mamba"]`` ({"conv": [L, B, K-1, di], "ssm": [L, B, di, n]}) to
the KV cache, slots on axis 1 like the cache, and each layer writes its
slice of both in place. An MoE layer (qwen2-moe, qwen3-moe) holds
``layers["moe"]`` in place of ``layers["ffn"]``, as the reference's tree
does; it keeps no state of its own, so its decode state is the KV cache
alone. xLSTM is heterogeneous (an mLSTM/sLSTM mix): its
params and decode state are lists of per-block dicts (``params["blocks"]``,
``state["blocks"]``), and its state leads with the slot axis. A
layer-pattern stack (a ``PatternConfig``: Nemotron-H) has one mixer a
layer, ``x + mixer(rmsnorm(x))``, in the pattern's order; its params and
decode state are grouped by kind, each group stacked over its own layers:
``layers["mamba2"]`` (Mamba-2, ``models/mamba2.py``), ``layers["attn"]``
(attention) and ``layers["mlp"]`` (the ungated MLP), each {"ln": {"g"},
"mixer": ...}; the state is {"kv": [L_attn, B, ...], "mamba2": {"conv":
[L_m, B, K-1, conv_dim], "ssm": [L_m, B, H, P, N]}}, slots on axis 1, a
group absent where the stack has no layer of its kind. Inside a prefill
on a card each Mamba-2 mixer is a ``prefill.mamba`` device range
(``obs.tracer``). The validity mask reaches every coded GEMM of every
layer or block.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ATTENTION, MAMBA2, MLP
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mamba2 as mamba2_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (Params, TPCtx, col_dense,
                                       linear_init, remat_layer, rmsnorm,
                                       tree_index, tree_unstack)
from repro_torch.obs.tracer import mamba_range, model_range


def xlstm_block_kinds(cfg) -> list[str]:
    """The static mLSTM/sLSTM schedule: every ``slstm_every``-th block is
    sLSTM (xLSTM[7:1] for the 125m config). Derived from cfg, never
    stored in the params."""
    return ["slstm" if cfg.slstm_every and (i + 1) % cfg.slstm_every == 0
            else "mlstm" for i in range(cfg.n_layers)]


def _is_xlstm(cfg) -> bool:
    return cfg.ssm_kind == "xlstm"


def _is_hybrid(cfg) -> bool:
    return cfg.family == "hybrid"


def _kinds(cfg) -> str:
    """A layer-pattern stack's layer kinds, in order ("" for any other
    decoder)."""
    return getattr(cfg, "layer_kinds", "")


# a layer-pattern stack's groups: kind -> group name
_GROUPS = {MAMBA2: "mamba2", ATTENTION: "attn", MLP: "mlp"}


def _pattern_init(cfg, gen, ctx: TPCtx, dtype, device) -> Params:
    """The layer groups of a layer-pattern stack, each stacked over the
    layers of its kind."""
    inits = {MAMBA2: mamba2_mod.mamba2_init, ATTENTION: attn_mod.attn_init,
             MLP: ffn_mod.ffn_init}
    layers = {}
    for kind, name in _GROUPS.items():
        n = _kinds(cfg).count(kind)
        if n:
            layers[name] = {
                "ln": {"g": torch.ones((n, cfg.d_model), device=device)},
                "mixer": inits[kind](gen, cfg, ctx, dtype, layers=(n,),
                                     device=device)}
    return layers


def _pattern_layers(cfg, layers: Params, unstack: bool = False):
    """(kind, layer params, the layer's index in its group) in the
    pattern's order; views of each group's slices (``unstack``: one
    ``unbind`` a leaf, for autograd)."""
    per = {}
    for kind, name in _GROUPS.items():
        n = _kinds(cfg).count(kind)
        if n:
            per[kind] = tree_unstack(layers[name], n) if unstack else \
                [tree_index(layers[name], i) for i in range(n)]
    seen = dict.fromkeys(per, 0)
    for kind in _kinds(cfg):
        yield kind, per[kind][seen[kind]], seen[kind]
        seen[kind] += 1


def _pattern_layer(cfg, ctx: TPCtx, kind: str, p: Params, x, valid,
                   cache, mamba_state, pos_offset, q_chunk, kv_chunk):
    if kind == MAMBA2:
        with model_range("host.layer.mamba"):
            xn = rmsnorm(p["ln"], x, cfg.norm_eps)
            with mamba_range():
                return x + mamba2_mod.mamba2(ctx, p["mixer"], cfg, xn, valid,
                                             mamba_state)
    if kind == ATTENTION:
        with model_range("host.layer.attn"):
            xn = rmsnorm(p["ln"], x, cfg.norm_eps)
            return x + attn_mod.attention(
                ctx, p["mixer"], cfg, xn, valid=valid, cache=cache,
                pos_offset=pos_offset, q_chunk=q_chunk, kv_chunk=kv_chunk)
    with model_range("host.layer.ffn"):
        xn = rmsnorm(p["ln"], x, cfg.norm_eps)
        return x + ffn_mod.ffn(ctx, p["mixer"], cfg, xn, valid)


def init_params(cfg, gen: torch.Generator, ctx: TPCtx,
                dtype=torch.float32, device=None) -> Params:
    """Random parameters drawn from ``gen`` on ``device``, in the
    reference's layout. Dense bodies (family ``dense``, and ``vlm``:
    chameleon-34b, which the reference builds as a dense decoder over a
    shared token vocabulary), mixtures of experts (``n_experts``: routed
    experts beside coded shared ones), hybrid attention + mamba layers
    (family ``hybrid``), layer-pattern stacks (``PatternConfig``) and
    xLSTM (``ssm_kind == "xlstm"``)."""
    if not (_is_xlstm(cfg) or cfg.family in ("dense", "vlm", "hybrid",
                                             "moe")):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported as a decoder-only LM "
            f"(dense, moe, hybrid and xLSTM are; an encoder-decoder is "
            f"built by models.encdec)")
    d, L = cfg.d_model, (cfg.n_layers,)
    vocab_pad = ctx.pad_dim(cfg.vocab)
    embed = torch.randn((vocab_pad, d), generator=gen, device=device)
    params: Params = {
        "embed": embed.mul_(0.02).to(dtype),
        "ln_f": {"g": torch.ones(d, device=device)},
        "lm_head": linear_init(gen, d, cfg.vocab, ctx, dtype,
                               scale=1.0 / d ** 0.5, device=device),
    }
    if _is_xlstm(cfg):
        params["blocks"] = [
            xlstm_mod.BLOCKS[kind].init(gen, cfg, ctx, dtype, device)
            for kind in xlstm_block_kinds(cfg)]
        return params
    if _kinds(cfg):
        params["layers"] = _pattern_init(cfg, gen, ctx, dtype, device)
        return params
    layers = {
        "ln1": {"g": torch.ones(L + (d,), device=device)},
        "attn": attn_mod.attn_init(gen, cfg, ctx, dtype, layers=L,
                                   device=device),
    }
    if _is_hybrid(cfg):
        layers["mamba"] = mamba_mod.mamba_init(gen, cfg, ctx, dtype,
                                               layers=L, device=device)
    layers["ln2"] = {"g": torch.ones(L + (d,), device=device)}
    if cfg.n_experts:
        layers["moe"] = ffn_mod.moe_init(gen, cfg, ctx, dtype, layers=L,
                                         device=device)
    else:
        layers["ffn"] = ffn_mod.ffn_init(gen, cfg, ctx, dtype, layers=L,
                                         device=device)
    params["layers"] = layers
    return params


def _layer_fwd(cfg, ctx: TPCtx, p: Params, x, valid, cache, mamba_state,
               pos_offset, q_chunk, kv_chunk):
    # profiler ranges while a timing recorder is attached (obs.tracer)
    with model_range("host.layer.attn"):
        xn = rmsnorm(p["ln1"], x, cfg.norm_eps)
        a = attn_mod.attention(ctx, p["attn"], cfg, xn, valid=valid,
                               cache=cache, pos_offset=pos_offset,
                               q_chunk=q_chunk, kv_chunk=kv_chunk)
        if "mamba" in p:
            m, _ = mamba_mod.mamba(ctx, p["mamba"], cfg, xn, valid,
                                   mamba_state)
            a = (a + m) * 0.5
        x = x + a
    if "moe" in p:
        with model_range("host.layer.moe"):
            xn = rmsnorm(p["ln2"], x, cfg.norm_eps)
            return x + ffn_mod.moe(ctx, p["moe"], cfg, xn, valid)
    with model_range("host.layer.ffn"):
        xn = rmsnorm(p["ln2"], x, cfg.norm_eps)
        return x + ffn_mod.ffn(ctx, p["ffn"], cfg, xn, valid)


def forward(cfg, params: Params, ctx: TPCtx, tokens: torch.Tensor,
            valid=None, *, remat: str = "full", q_chunk: int = 512,
            kv_chunk: int = 1024) -> torch.Tensor:
    """tokens: [B, S] -> logits [B, S, vocab] (float32), teacher-forced:
    every position attends the tokens before it (or its window), no
    cache. Under grad mode each layer (each xLSTM block) is checkpointed
    by ``remat`` ("none", "dots" or "full"), as the reference wraps its
    scan body."""
    x = params["embed"][tokens.long()]
    if _is_xlstm(cfg):
        for kind, p in zip(xlstm_block_kinds(cfg), params["blocks"]):
            block = remat_layer(
                lambda x, p, fn=xlstm_mod.BLOCKS[kind].apply:
                fn(ctx, p, cfg, x, valid)[0], remat)
            x = block(x, p)
    elif _kinds(cfg):
        for kind, p, _ in _pattern_layers(cfg, params["layers"],
                                          unstack=True):
            layer = remat_layer(
                lambda x, p, kind=kind: _pattern_layer(
                    cfg, ctx, kind, p, x, valid, None, None, 0, q_chunk,
                    kv_chunk), remat)
            x = layer(x, p)
    else:
        layer = remat_layer(
            lambda x, p: _layer_fwd(cfg, ctx, p, x, valid, None, None, 0,
                                    q_chunk, kv_chunk), remat)
        for p in tree_unstack(params["layers"], cfg.n_layers):
            x = layer(x, p)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = col_dense(ctx, params["lm_head"], x, cfg.vocab, valid)
    return logits.to(torch.float32)


def init_decode_state(cfg, ctx: TPCtx, batch: int, max_len: int,
                      dtype=torch.float32, device=None) -> Params:
    """{"kv": {"k","v": [L,B,C,Hkv,hd], "pos": [L,B,C], "len": [L,B]}},
    the per-row (slot-batched) layout (a layer-pattern stack's is grouped
    by kind: the module's docstring); a hybrid adds {"mamba": {"conv":
    [L,B,K-1,di] in ``dtype``, "ssm": [L,B,di,n] float32}} (zeros, as the
    reference's); for xLSTM {"blocks": [one state per block, batch axis
    leading]} (positionless: ``max_len`` and ``dtype`` do not apply, the
    recurrences run in float32)."""
    if _is_xlstm(cfg):
        return {"blocks": [xlstm_mod.BLOCKS[kind].state(cfg, batch, device)
                           for kind in xlstm_block_kinds(cfg)]}
    if _kinds(cfg):
        n_attn, n_m = _kinds(cfg).count(ATTENTION), _kinds(cfg).count(MAMBA2)
        state = {}
        if n_attn:
            state["kv"] = attn_mod.init_cache(cfg, batch, max_len, dtype,
                                              tp=ctx.tp, layers=(n_attn,),
                                              device=device)
        if n_m:
            state["mamba2"] = mamba2_mod.init_mamba2_state(
                cfg, batch, dtype, layers=(n_m,), device=device)
        return state
    L = (cfg.n_layers,)
    state = {"kv": attn_mod.init_cache(cfg, batch, max_len, dtype,
                                       tp=ctx.tp, layers=L, device=device)}
    if _is_hybrid(cfg):
        state["mamba"] = mamba_mod.init_mamba_state(cfg, batch, dtype,
                                                    layers=L, device=device)
    return state


def decode_step(cfg, params: Params, ctx: TPCtx, state: Params,
                tokens: torch.Tensor, valid=None, *, kv_chunk: int = 1024,
                last_only: bool = False, return_hidden: bool = False):
    """tokens: [B, s] -> (logits [B, s, V] f32, state); the KV cache (and
    a hybrid's mamba state, or the xLSTM block states) in ``state`` is
    updated in place and returned.

    last_only: logits for the final position only. return_hidden: skip
    the LM head and return the post-ln_f hidden states (the fused round
    feeds them to the fused head kernel)."""
    x = params["embed"][tokens.long()]
    if _is_xlstm(cfg):
        for kind, p, st in zip(xlstm_block_kinds(cfg), params["blocks"],
                               state["blocks"]):
            x, _ = xlstm_mod.BLOCKS[kind].apply(ctx, p, cfg, x, valid, st)
    elif _kinds(cfg):
        kv, ms = state.get("kv"), state.get("mamba2")
        s = tokens.shape[1]
        pos = None if kv is None else kv["len"][0].clone()
        for kind, p, i in _pattern_layers(cfg, params["layers"]):
            cache = {name: kv[name][i] for name in ("k", "v", "pos", "len")} \
                if kind == ATTENTION else None
            mst = tree_index(ms, i) if kind == MAMBA2 else None
            x = _pattern_layer(cfg, ctx, kind, p, x, valid, cache, mst, pos,
                               s, kv_chunk)
        if kv is not None:
            kv["len"] += s
    else:
        kv, ms = state["kv"], state.get("mamba")
        s = tokens.shape[1]
        pos = kv["len"][0].clone()      # [B]; the same for every layer
        for i in range(cfg.n_layers):
            cache = {name: kv[name][i] for name in ("k", "v", "pos", "len")}
            mst = None if ms is None else tree_index(ms, i)
            x = _layer_fwd(cfg, ctx, tree_index(params["layers"], i), x,
                           valid, cache, mst, pos, s, kv_chunk)
        kv["len"] += s
    if last_only:
        x = x[:, -1:]
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if return_hidden:
        return x, state
    with model_range("host.head"):
        logits = col_dense(ctx, params["lm_head"], x, cfg.vocab, valid)
        return logits.to(torch.float32), state
