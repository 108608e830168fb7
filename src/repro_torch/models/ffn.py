"""FFN blocks: dense (SwiGLU / GELU / squared ReLU) and Mixture-of-Experts.

Dense: W1/W3 are column-parallel, so coded in coded mode; W2 is
row-parallel and never coded (paper Table 1).

MoE: CDC is NOT applied across the routed experts — routing depends on
the input, so no shared factor exists between expert outputs (the same
algebra that rules out input splitting, paper Eq. 13-14). The shared
experts are an ordinary dense FFN and ARE coded. Dispatch is sort-based
with a capacity bound, as the reference's: a stable sort of the routed
(token, expert) pairs by expert, each pair's position in its expert's
group, a dense [E, cap, D] buffer and three batched products over every
expert's weights (``torch.bmm``: the reference's einsums, outside any
TPU kernel). With a mesh in ``ctx`` whose TP axis (size tp > 1) divides
the expert count, ``moe`` takes the reference's expert-parallel path
(``_moe_sharded``): each rank of the TP line holds e / tp experts, routes
its tokens, runs its own experts only, and one all-reduce over the line
combines.

Every step runs on the device with static shapes (``cap`` is a Python
int from static sizes), so a round with an MoE layer can be captured in a
CUDA graph, and the combine sums each token's k contributions in a fixed
order (no atomics): graph replays and eager rounds agree to the bit.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import (Params, TPCtx, activation, col_dense,
                                       linear_init, row_dense)


def ffn_init(gen: torch.Generator, cfg, ctx: TPCtx, dtype,
             layers: tuple[int, ...] = (), device=None,
             d_ff: int | None = None) -> Params:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    kw = dict(layers=layers, device=device)
    p = {
        "w1": linear_init(gen, d, f, ctx, dtype, **kw),
        "w2": linear_init(gen, f, d, ctx, dtype, scale=1.0 / f ** 0.5,
                          coded=False, **kw),
    }
    if cfg.act == "silu":  # gated
        p["w3"] = linear_init(gen, d, f, ctx, dtype, **kw)
    return p


def ffn(ctx: TPCtx, p: Params, cfg, x: torch.Tensor, valid=None,
        d_ff: int | None = None) -> torch.Tensor:
    f = d_ff if d_ff is not None else cfg.d_ff
    h = activation(cfg.act, col_dense(ctx, p["w1"], x, f, valid))
    if "w3" in p:
        h = h * col_dense(ctx, p["w3"], x, f, valid)
    return row_dense(ctx, p["w2"], h)


# ------------------------------------------------------------------ MoE ----

def _pad_experts(n_experts: int, tp: int) -> int:
    """The expert count rounded up to a multiple of the TP degree, as the
    reference pads it (qwen2's 60 -> 64 at T = 16; the extra experts are
    real parameters the router rarely selects)."""
    return ((n_experts + tp - 1) // tp) * tp


def moe_init(gen: torch.Generator, cfg, ctx: TPCtx, dtype,
             layers: tuple[int, ...] = (), device=None) -> Params:
    """{"router": {"w": [d, e]}, "we1", "we3": [e, d, fe], "we2": [e, fe,
    d]} (and "shared", a dense FFN of ``n_shared_experts * d_ff_expert``,
    coded), with optional leading stacked-layer dims. The router has no
    parity leaf, so ``encode_tree`` leaves it as it is."""
    d, fe = cfg.d_model, cfg.d_ff_expert
    e = _pad_experts(cfg.n_experts, ctx.tp)

    def normal(shape, scale):
        w = torch.randn(layers + shape, generator=gen, device=device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dtype)

    scale = 1.0 / d ** 0.5
    p: Params = {"router": {"w": normal((d, e), scale)},
                 "we1": normal((e, d, fe), scale),
                 "we3": normal((e, d, fe), scale),
                 "we2": normal((e, fe, d), 1.0 / fe ** 0.5)}
    if cfg.n_shared_experts:
        p["shared"] = ffn_init(gen, cfg, ctx, dtype, layers, device,
                               d_ff=cfg.n_shared_experts * fe)
    return p


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest of each row, ties to the lower index
    (the first k of a stable descending sort; ``torch.topk`` promises no
    order between equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(ctx: TPCtx, router_w, xf, k: int, e: int):
    """The routing math: top-k gates and the dispatch order sorted by
    expert. Returns (se, sg, st, pos, keep, cap): for each of the m = n·k
    routed pairs in sorted order its expert, gate and token, its position
    in its expert's group, whether it fits the capacity, and the
    capacity."""
    n = xf.shape[0]
    # the product in the weights' dtype, then float32 for the softmax
    logits = (xf @ router_w).to(torch.float32)                 # [N, E]
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = _top_k(probs, k)                             # [N, k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    m = n * k
    flat_e, flat_g = eidx.reshape(m), gates.reshape(m)
    flat_t = torch.arange(n, device=xf.device)[:, None].expand(n, k) \
        .reshape(m)
    order = torch.argsort(flat_e, stable=True)
    se, sg, st = flat_e[order], flat_g[order], flat_t[order]
    grp_start = torch.searchsorted(se, se)
    pos = torch.arange(m, device=xf.device) - grp_start
    if ctx.moe_capacity and ctx.moe_capacity > 0:
        cap = int(max(1, ctx.moe_capacity * m / e))
    else:
        cap = m  # no dropping (exactness mode; memory O(E * m))
    return se, sg, st, pos, pos < cap, cap


def _expert_ffn(buf, we1, we3, we2):
    """Every expert's SwiGLU over its slots: [E, cap, D] -> [E, cap, D]."""
    h = activation("silu", torch.bmm(buf, we1))
    h = h * torch.bmm(buf, we3)
    return torch.bmm(h, we2)


def moe(ctx: TPCtx, p: Params, cfg, x: torch.Tensor, valid=None
        ) -> torch.Tensor:
    """Top-k routed MoE with sort-based capacity dispatch, plus the coded
    shared experts. x: [B, S, D] -> [B, S, D]."""
    b, s, d = x.shape
    k = cfg.top_k
    e = p["router"]["w"].shape[-1]
    mesh = ctx.mesh
    tp = mesh.shape[ctx.axis] \
        if mesh is not None and ctx.axis in mesh.axis_names else 1
    if tp > 1 and e % tp == 0:
        y, split = _moe_sharded(ctx, p, cfg, x.reshape(b * s, d), e, k, tp)
        if split:
            # every rank holds the whole activation: gather the batch
            # blocks back (GSPMD keeps them placed, the values are these)
            from repro_torch.dist import comm
            y = comm.all_gather(y, mesh.group(split)).reshape(b * s, d)
        y = y.reshape(b, s, d)
    else:
        y = _moe_local(ctx, p, x.reshape(b * s, d), e, k).reshape(b, s, d)
    if "shared" in p:
        y = y + ffn(ctx, p["shared"], cfg, x, valid,
                    d_ff=cfg.n_shared_experts * cfg.d_ff_expert)
    return y


def _moe_local(ctx: TPCtx, p: Params, xf, e: int, k: int):
    """Route every token over all e experts, dispatch, the experts'
    products, combine (``_dispatch_combine``)."""
    se, sg, st, pos, keep, cap = _route(ctx, p["router"]["w"], xf, k, e)
    return _dispatch_combine(xf, se, sg, st, pos, keep, cap, e, p["we1"],
                             p["we3"], p["we2"])


def _dispatch_combine(xf, le, sg, st, pos, mine, cap: int, n_e: int,
                      we1, we3, we2):
    """Dispatch the routed pairs marked ``mine`` to the n_e experts held
    here (``le``: each pair's expert among them), run the experts, and
    combine. The buffer is [n_e * cap + 1, D]: expert-major slots, then a
    spare row that takes every other pair (beyond the capacity, or another
    rank's expert: never read; such a pair adds nothing to its token), so
    the dispatched rows are unique and the dispatch is a plain indexed
    write, and the experts read a contiguous [n_e, cap, D] view. The
    combine takes the gated contributions to token-major order (a stable
    sort by token keeps each token's k pairs in expert order, the order in
    which the reference's scatter-add sums them), [n, k, D], and sums over
    k in float32."""
    n, d = xf.shape
    k = le.shape[0] // n
    slot = le * cap + torch.clamp(pos, max=cap - 1)
    spare = n_e * cap
    buf = torch.zeros((spare + 1, d), dtype=xf.dtype, device=xf.device)
    buf[torch.where(mine, slot, spare)] = xf[st]
    out = _expert_ffn(buf[:spare].view(n_e, cap, d), we1, we3,
                      we2).view(spare, d)
    contrib = torch.where(mine[:, None],
                          out[slot].to(torch.float32) * sg[:, None], 0.0)
    by_token = torch.argsort(st, stable=True)
    return contrib[by_token].reshape(n, k, d).sum(1).to(xf.dtype)


def _moe_sharded(ctx: TPCtx, p: Params, cfg, xf, e: int, k: int, tp: int):
    """The expert-parallel path on this rank (the reference's full-manual
    shard_map): tokens stay on their batch block, experts on their EP
    rank; routing is local (the rank's tokens), the dispatch is local,
    and the combine is ONE all-reduce over the TP line, the only message.

    xf: [n, D] tokens (the same on every rank); p's expert slabs either
    whole ([e, ...]: the rank reads its own e / tp) or the rank's own block
    ([e / tp, ...], as ``dist.shard_params`` gives them); the router whole.
    Tokens split over the batch axes (pod and ``ctx.fsdp``) where their
    product divides n, and are replicated otherwise. Returns (this rank's
    [n_local, D] output, the batch axes split over: () when replicated)."""
    import torch.distributed as dist
    from repro_torch.dist import comm
    from repro_torch.dist.collectives import batch_block

    e_local = e // tp
    mesh = ctx.mesh
    rank = dist.get_rank()
    axes = tuple(a for a in ("pod", ctx.fsdp)
                 if a and a in mesh.axis_names)
    xl, split = batch_block(xf, mesh, axes, rank)
    e0 = mesh.coords(rank)[ctx.axis] * e_local
    we = [p[name] if p[name].shape[0] == e_local
          else p[name][e0:e0 + e_local] for name in ("we1", "we3", "we2")]
    se, sg, st, pos, keep, cap = _route(ctx, p["router"]["w"], xl, k, e)
    mine = (se >= e0) & (se < e0 + e_local) & keep
    y = _dispatch_combine(xl, torch.clamp(se - e0, 0, e_local - 1), sg, st,
                          pos, mine, cap, e_local, *we)
    return comm.all_reduce(y, mesh.group(ctx.axis)), split


def moe_aux_loss(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Load-balance auxiliary loss (Switch-style): E * sum_e f_e * p_e."""
    d = x.shape[-1]
    logits = (x.reshape(-1, d) @ p["router"]["w"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    e = probs.shape[-1]
    _, eidx = _top_k(probs, cfg.top_k)
    frac = torch.nn.functional.one_hot(eidx, e).to(torch.float32) \
        .mean(dim=(0, 1))
    return e * torch.sum(frac * probs.mean(0))
