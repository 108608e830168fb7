"""Shared model machinery: TP context, coded/plain dense, norms, RoPE, init.

Models are plain functions over parameter dicts of tensors, laid out as
the reference lays them out (stacked [L, ...] layer weights). The CDC
behaviour is threaded through ``TPCtx``: in coded mode every
column-parallel GEMM runs through ``core.coded_matmul``; row-parallel
GEMMs (attention Wo, FFN W2) are never coded (paper Table 1). ``TPCtx``
carries the reference's mesh fields: under GSPMD its ``shard`` /
``shard_act`` are placement constraints that change no value, and the
port's return x as it is (every rank holds the whole activation). The mesh
itself is read by the MoE's expert-parallel path (``ffn._moe_sharded``);
the explicit per-rank coded GEMM is ``dist.coded_matmul_shardmap``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.coded_layer import (CodedDenseSpec, coded_matmul,
                                          make_parity_weights)
from repro_torch.core.coding import CodeSpec
from repro_torch.kernels import ops

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TPCtx:
    """Static tensor-parallel + CDC context for a model invocation."""

    tp: int = 1                    # T: logical shards of every coded GEMM
    mode: str = "plain"            # plain | coded
    code_r: int = 2
    code_layout: str = "folded"
    mesh: Any = None               # dist.sharding.Mesh over the world (opt.)
    axis: str = "model"            # TP axis name
    fsdp: str | None = "data"      # FSDP axis name (weights)
    seq_axis: str | None = None    # SP: shard sequence dim of activations
    moe_capacity: float = 1.25     # MoE capacity factor (<= 0: no dropping)
    fused_body: bool = False       # route coded GEMMs through the fused
    #                                coded-GEMM kernel; only valid for
    #                                <= 1 erasure (the executor gates it)
    fused_decode: bool = False     # keep the unfused products, decode and
    #                                merge through the decode-and-merge
    #                                kernel (the stepper's prefill sets it)

    @property
    def coded(self) -> bool:
        return self.mode == "coded" and self.tp > 1

    @property
    def spec(self) -> CodedDenseSpec | None:
        if not self.coded:
            return None
        return CodedDenseSpec(CodeSpec(self.tp, self.code_r),
                              layout=self.code_layout)

    def pad_dim(self, m: int) -> int:
        """Column dims of coded GEMMs split into T x T slices; plain mode
        pads the same so parameter shapes match across modes."""
        q = self.tp * self.tp
        return ((m + q - 1) // q) * q

    def shard(self, x: torch.Tensor, *spec) -> torch.Tensor:
        """The reference's placement constraint: no value changes, so x as
        it is."""
        return x

    def shard_act(self, x: torch.Tensor, col: bool = False) -> torch.Tensor:
        """The reference's activation constraint (batch over fsdp + pod,
        optionally the last dim over the TP axis): x as it is."""
        return x


# ---------------------------------------------------------------- dense ----

def linear_init(gen: torch.Generator, k: int, m: int, ctx: TPCtx, dtype,
                scale: float | None = None, coded: bool = True,
                layers: tuple[int, ...] = (), device=None,
                parity: bool = True) -> Params:
    """A (possibly coded) linear layer's params, with optional leading
    stacked-layer dims. Stores the padded weight; padded columns are 0.
    parity=False leaves the parity leaf to the caller (``encode_leaf``),
    who changes the weight first."""
    m_pad = ctx.pad_dim(m) if coded else m
    scale = scale if scale is not None else 1.0 / math.sqrt(k)
    w = torch.randn(layers + (k, m_pad), generator=gen, device=device,
                    dtype=torch.float32)
    w.mul_(scale)
    if m_pad != m:
        w[..., m:] = 0.0
    p: Params = {"w": w.to(dtype)}
    if coded and ctx.coded and parity:
        encode_leaf(p, ctx)
    return p


def encode_leaf(p: Params, ctx: TPCtx) -> Params:
    """(Re)compute the parity leaf of one coded layer from its weight."""
    p["cdc"] = make_parity_weights(p["w"], ctx.spec)
    return p


def col_dense(ctx: TPCtx, p: Params, x: torch.Tensor, out_dim: int,
              valid=None) -> torch.Tensor:
    """Column-parallel (output-split) GEMM — codeable (paper Table 1)."""
    w = p["w"]
    if ctx.coded and "cdc" in p:
        y = coded_matmul(x, w, p["cdc"], ctx.spec, valid,
                         use_fused=ctx.fused_body,
                         fused_decode=ctx.fused_decode)
    else:
        y = x @ w
    return y[..., :out_dim] if y.shape[-1] != out_dim else y


def row_dense(ctx: TPCtx, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Row-parallel (input-split) GEMM — not codeable (paper Eq. 13-14)."""
    return x @ p["w"]


def encode_tree(params: Params, ctx: TPCtx) -> Params:
    """(Re)compute every parity leaf from its base weight — the paper's
    offline encode. The returned tree SHARES every base tensor with
    ``params`` (only the dict nodes holding parity are new): at full width
    a copy of the base weights would not fit beside the parity."""
    if not ctx.coded:
        return params

    def walk(node):
        if isinstance(node, dict):
            if "w" in node and "cdc" in node:
                return encode_leaf(dict(node), ctx)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


REMAT = ("none", "dots", "full")


def _keep_dots():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    aten = torch.ops.aten
    return create_selective_checkpoint_contexts(
        [aten.mm.default, aten.bmm.default, aten.addmm.default])


def remat_layer(f, policy: str = "full"):
    """The reference's ``_remat``: a layer ``f`` whose activations the
    backward recomputes instead of keeping (``torch.utils.checkpoint``,
    non-reentrant). "none": f as it is; "dots": keep the matmul outputs
    (aten mm, bmm, addmm: ``checkpoint_dots``) and recompute the rest;
    "full": keep only the layer's inputs. Outside grad mode f runs as it
    is, so inference is unchanged."""
    if policy not in REMAT:
        raise ValueError(f"remat {policy!r} is not one of {REMAT}")
    if policy == "none":
        return f
    from torch.utils.checkpoint import checkpoint
    extra = {"context_fn": _keep_dots} if policy == "dots" else {}

    def run(*args):
        if not torch.is_grad_enabled():
            return f(*args)
        return checkpoint(f, *args, use_reentrant=False,
                          preserve_rng_state=False, **extra)
    return run


def tree_unstack(node, n: int) -> list:
    """The ``n`` layers of a stacked [L, ...] tree as a list of trees of
    views, one ``unbind`` a leaf. Under autograd the layers' gradients of
    a leaf come back as one stack, where slicing each layer out
    (``tree_index``) would give each its own zero-filled full-size
    gradient to add up."""
    if isinstance(node, dict):
        per = {k: tree_unstack(v, n) for k, v in node.items()}
        return [{k: per[k][i] for k in node} for i in range(n)]
    return list(node.unbind(0))


def tree_index(node, i: int):
    """Slice layer ``i`` out of a stacked [L, ...] tree (views, no copy)."""
    if isinstance(node, dict):
        return {k: tree_index(v, i) for k, v in node.items()}
    return node[i]


# ---------------------------------------------------------------- norms ----

def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Row RMSNorm with float32 math: the rmsnorm kernel on a CUDA tensor
    (one launch), its plain version (the reference's arithmetic) on a CPU
    tensor."""
    return ops.rmsnorm(x, p["g"], eps=eps)


def layernorm_init(d: int, layers: tuple[int, ...] = (), device=None
                   ) -> Params:
    return {"g": torch.ones(layers + (d,), device=device),
            "b": torch.zeros(layers + (d,), device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Row LayerNorm with float32 math (biased variance), output in x's
    dtype. The reference's is plain JAX, not a TPU kernel, so one
    ``F.layer_norm`` launch serves here."""
    g, b = p["g"].to(torch.float32), p["b"].to(torch.float32)
    return F.layer_norm(x.to(torch.float32), g.shape, g, b, eps).to(x.dtype)


# ----------------------------------------------------------------- rope ----

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] (broadcastable)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos,
                     x[..., 2 * half:]], dim=-1)
    return rot.to(x.dtype)


def sinusoidal_pos(seq: int, d: int, dtype=torch.float32, device=None
                   ) -> torch.Tensor:
    """[seq, d] sinusoidal position table: sin in the even columns, cos in
    the odd ones, as the reference builds it."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: (d + 1) // 2])
    return pe.to(dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus as jax.nn.softplus computes it: max(x, 0) +
    log1p(exp(-|x|))."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    if name == "relu2":
        # squared ReLU (Nemotron-H's ungated MLP)
        return torch.square(F.relu(x))
    raise ValueError(name)
