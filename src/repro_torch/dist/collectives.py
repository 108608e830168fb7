"""Explicit per-rank coded GEMM (the reference's shard_map twin).

``core.coded_matmul`` computes the paper's coded output-split GEMM in one
process. ``coded_matmul_shardmap`` pins shard to rank: model rank i holds
weight columns [i*m_l, (i+1)*m_l) and (folded layout) parity slot i, runs
its GEMMs locally, crosses the `model` line with an all-gather of the T
shard outputs (and the parity messages), and reruns the single-process
recovery (``core.decode_and_merge``) on every rank: the decode-and-merge
kernel (kernel 3, ``kernels.ops.fused_decode_merge``) on a CUDA tensor
under at most one dead shard, the plain path beyond, as the reference's
ladder goes.

A dead rank's messages are what the mask says they are: it computes
nothing and sends NaN as its data message and its folded parity slot, so
an output that read them would show it. The decode zeroes them by select.

This is the placement the paper measures (§6: each worker owns one weight
split; the master gathers T of the T + r messages and subtracts locally).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.coded_layer import (CodedDenseSpec, decode_and_merge,
                                          merge_shards)
from repro_torch.core.coding import host_mask
from repro_torch.dist import comm
from repro_torch.dist.sharding import batch_axes, block_index

__all__ = ["coded_matmul_shardmap", "batch_block"]


def batch_block(x: torch.Tensor, mesh, axes: tuple[str, ...],
                rank: int) -> tuple[torch.Tensor, tuple[str, ...]]:
    """``rank``'s block of x's rows over the batch ``axes`` where their
    product divides x.shape[0] (and x has a batch dim), else x whole; with
    the axes actually split over."""
    n_b = 1
    for a in axes:
        n_b *= mesh.shape[a]
    if x.ndim < 2 or n_b <= 1 or x.shape[0] % n_b:
        return x, ()
    (part, parts), = block_index((axes,), mesh, rank)
    n = x.shape[0] // parts
    return x.narrow(0, part * n, n), axes


def coded_matmul_shardmap(x: torch.Tensor, w: torch.Tensor,
                          w_cdc: torch.Tensor | None, spec: CodedDenseSpec,
                          valid=None, *, mesh, axis: str = "model",
                          valid_parity=None) -> torch.Tensor:
    """The coded GEMM across the ranks of the ``axis`` line (same arguments
    as the reference, plus the mesh).

    x: [..., k] activations (its leading dim is split over the non-model
    batch axes where they divide it); w: [k, m] with m = T * m_l; requires
    ``mesh.shape[axis] == T`` so shard i is model-rank i. Every rank passes
    the same arguments and reads only its own blocks of w and w_cdc.
    Returns this rank's block of the merged [..., m] (its batch rows, all m
    columns), equal to ``x @ w`` under <= budget erasures.
    """
    code = spec.code
    T = code.n_shards
    if axis not in mesh.axis_names or mesh.shape[axis] != T:
        raise ValueError(
            f"mesh axis {axis!r} must exist with size T={T}, got "
            f"{dict(mesh.shape)}")
    k, m = w.shape
    if m % T:
        raise ValueError(f"output dim {m} not divisible by T={T}")

    coded = w_cdc is not None and code.n_parity > 0 and valid is not None
    folded = coded and spec.layout == "folded"
    if coded and valid_parity is None:
        valid_parity = valid
    rank = dist.get_rank()
    i = mesh.coords(rank)[axis]
    line = mesh.group(axis)
    b_axes = tuple(a for a in batch_axes(mesh) if a != axis)
    xb, _ = batch_block(x, mesh, b_axes, rank)

    m_l = m // T
    dead = coded and not bool(host_mask(valid)[i])
    out_shape = xb.shape[:-1] + (m_l,)
    if dead:
        y_i = torch.full(out_shape, float("nan"), dtype=x.dtype,
                         device=x.device)
    else:
        y_i = xb @ w[:, i * m_l:(i + 1) * m_l]
    ys = comm.all_gather(y_i, line)                       # [T, ..., m_l]
    if not coded:
        return merge_shards(ys)
    if folded:
        slot_dead = dead or not bool(host_mask(valid_parity)[i])
        if slot_dead:
            p_i = torch.full(xb.shape[:-1] + (w_cdc.shape[-1],),
                             float("nan"), dtype=x.dtype, device=x.device)
        else:
            p_i = xb @ w_cdc[i]                           # [..., r*w] my slot
        parity = comm.all_gather(p_i, line)               # [T, ..., r*w]
    else:
        # dedicated parity: the +r parity workers live off this mesh line;
        # every rank re-derives their messages locally (r/T of the data
        # GEMM) instead of dedicating ranks
        lead = xb.shape[:-1]
        parity = torch.matmul(xb.reshape(1, -1, k), w_cdc).reshape(
            (w_cdc.shape[0],) + lead + (w_cdc.shape[-1],))
    return decode_and_merge(ys, parity, spec, valid,
                            valid_parity=valid_parity, use_fused=True)
