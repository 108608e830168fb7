"""GPipe-style pipeline parallelism over the ``pod`` mesh axis.

A stacked-layer model ([L, ...] params driven layer by layer) is cut into
S = mesh.shape["pod"] contiguous stages of L/S layers, stage s on the rank
at pod index s. The batch splits into microbatches; each tick every stage
applies its layers to its current microbatch and passes the activation to
the next stage round the ring (the reference's ``ppermute``), so after the
S-1-tick fill the stages run concurrently (bubble fraction (S-1)/(n_mb + S
- 1), the GPipe schedule). The batch dim inside a microbatch additionally
splits over ``data``. The last stage's results are broadcast to every
stage (the reference's zero-elsewhere ``psum``).

A stage computes only on the ticks that carry one of its microbatches
(t - s in [0, n_mb)); on the fill and drain ticks the reference's stage
computes on a zero or stale input whose result no one reads, and the port's
skips the layers and passes zeros on. The values are the same.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist import comm
from repro_torch.tree import leaves, tree_map

__all__ = ["pipeline_apply"]


def _seq_apply(layer, params, x, lo: int, hi: int):
    for i in range(lo, hi):
        x = layer(tree_map(lambda a: a[i], params), x)
    return x


def pipeline_apply(layer, params, x: torch.Tensor, *, mesh,
                   n_microbatches: int = 4, axis: str = "pod"
                   ) -> torch.Tensor:
    """Run ``x`` through L stacked layers, pipelined over ``axis``.

    layer:  fn(layer_params, h) -> h for ONE layer (params without the L dim)
    params: a tree with leading [L, ...] on every leaf (a stage reads only
            its own layers' slices)
    x:      [B, ...] activations; B % n_microbatches == 0
    Returns the sequential layer-by-layer result: [B, ...] on every rank,
    or, where ``data`` splits the microbatches, this rank's rows of each
    microbatch ([n_mb * mb / n_data, ...]).
    """
    L = leaves(params)[0].shape[0]
    if axis not in mesh.axis_names or mesh.shape[axis] == 1:
        return _seq_apply(layer, params, x, 0, L)  # sequential
    S = mesh.shape[axis]
    if L % S:
        raise ValueError(f"n_layers {L} not divisible by {S} stages")
    B = x.shape[0]
    n_mb = n_microbatches
    if B % n_mb:
        raise ValueError(f"batch {B} not divisible by {n_mb} microbatches")
    mb = B // n_mb
    rank = dist.get_rank()
    c = mesh.coords(rank)
    stage = c[axis]
    x_mb = x.reshape((n_mb, mb) + x.shape[1:])
    if "data" in mesh.axis_names and mb % mesh.shape["data"] == 0:
        n = mb // mesh.shape["data"]
        x_mb = x_mb.narrow(1, c["data"] * n, n)
    line = mesh.group(axis)
    lo, hi = stage * (L // S), (stage + 1) * (L // S)

    out = torch.zeros_like(x_mb)
    recv = torch.zeros_like(x_mb[0])
    for t in range(n_mb + S - 1):
        j = t - stage                       # this stage's microbatch
        if 0 <= j < n_mb:
            inp = x_mb[j] if stage == 0 else recv
            y = _seq_apply(layer, params, inp, lo, hi)
            if stage == S - 1:
                out[j] = y
        else:
            y = torch.zeros_like(recv)
        recv = comm.ring_shift(y, line)
    comm.broadcast(out, line.ranks[S - 1], line)
    return out.reshape((-1,) + out.shape[2:])
