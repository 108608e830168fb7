"""The port's message transport: every message between ranks goes through
here.

Each function takes the ``sharding.Line`` of ranks it runs over (a mesh
line's process group, or ``world_line()``); a line of one rank moves
nothing. On NCCL, CUDA tensors go to the collective as they are. On gloo
(a CPU transport: NCCL refuses two ranks of one communicator on one GPU,
so ranks that share a card talk over gloo) a CUDA tensor is staged
explicitly: copied into a pinned host buffer, the stream synchronised, the
message moved between host buffers, and the result copied back to the
card. Pinned buffers are kept per (use, shape, dtype) and reused: the
stream is synchronised before every collective, so the copy out of a
buffer from the previous call has finished before it is overwritten.

``COUNTS`` adds up what this rank's messages carry, as payload: an
all-gather sends the rank's tensor and receives the n - 1 others; an
all-reduce sends the rank's tensor and receives the sum; a ring shift
sends one tensor and receives one; a broadcast sends from the source and
receives elsewhere; a gather sends from every rank but the destination,
which receives the n - 1 others. ``staged`` counts the bytes copied
between the card and host buffers.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import Line

__all__ = ["COUNTS", "reset", "world_line", "all_gather", "all_reduce",
           "broadcast", "ring_shift", "gather", "barrier"]

COUNTS = {"calls": 0, "sent": 0, "received": 0, "staged": 0}
_PINNED: dict[tuple, torch.Tensor] = {}


def reset() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def world_line() -> Line:
    """Every rank of the world, over the default group."""
    return Line(tuple(range(dist.get_world_size())), None)


def _count(sent: int, received: int) -> None:
    COUNTS["calls"] += 1
    COUNTS["sent"] += sent
    COUNTS["received"] += received


def _staged(t: torch.Tensor, line: Line) -> bool:
    return t.is_cuda and dist.get_backend(line.group) != "nccl"


def _pinned(use: str, shape, dtype) -> torch.Tensor:
    key = (use, tuple(shape), dtype)
    buf = _PINNED.get(key)
    if buf is None:
        buf = _PINNED[key] = torch.empty(shape, dtype=dtype, pin_memory=True)
    return buf


def _to_host(use: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` (on the card) in a pinned host buffer, the copy finished."""
    h = _pinned(use, t.shape, t.dtype)
    h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    COUNTS["staged"] += t.numel() * t.element_size()
    return h


def _to_card(h: torch.Tensor, like: torch.Tensor,
             out: torch.Tensor | None = None) -> torch.Tensor:
    out = torch.empty(h.shape, dtype=h.dtype, device=like.device) \
        if out is None else out
    out.copy_(h, non_blocking=True)
    COUNTS["staged"] += h.numel() * h.element_size()
    return out


def all_gather(t: torch.Tensor, line: Line) -> torch.Tensor:
    """[n, *t.shape]: every rank's ``t`` in line order, on t's device."""
    t = t.contiguous()
    n = line.size
    if n == 1:
        return t.unsqueeze(0)
    nb = t.numel() * t.element_size()
    _count(nb, (n - 1) * nb)
    if _staged(t, line):
        src = _to_host("all_gather.in", t)
        out = _pinned("all_gather.out", (n,) + tuple(t.shape), t.dtype)
        dist.all_gather(list(out.unbind(0)), src, group=line.group)
        return _to_card(out, t)
    out = t.new_empty((n,) + tuple(t.shape))
    if t.is_cuda:
        dist.all_gather_into_tensor(out, t, group=line.group)
    else:
        dist.all_gather(list(out.unbind(0)), t, group=line.group)
    return out


def all_reduce(t: torch.Tensor, line: Line) -> torch.Tensor:
    """The sum of every rank's ``t`` (a new tensor on t's device; summed
    in t's dtype, in the transport's order, the same on every rank)."""
    if line.size == 1:
        return t
    nb = t.numel() * t.element_size()
    _count(nb, nb)
    if _staged(t, line):
        h = _to_host("all_reduce", t.contiguous())
        dist.all_reduce(h, group=line.group)
        return _to_card(h, t)
    out = t.contiguous().clone()
    dist.all_reduce(out, group=line.group)
    return out


def broadcast(t: torch.Tensor, src: int, line: Line) -> torch.Tensor:
    """Global rank ``src``'s ``t`` on every rank of the line, written into
    ``t`` (contiguous) in place."""
    if line.size == 1:
        return t
    nb = t.numel() * t.element_size()
    me = dist.get_rank()
    _count(nb if me == src else 0, 0 if me == src else nb)
    if _staged(t, line):
        h = _to_host("broadcast", t)
        dist.broadcast(h, src, group=line.group)
        if me != src:
            _to_card(h, t, out=t)
        return t
    dist.broadcast(t, src, group=line.group)
    return t


def ring_shift(t: torch.Tensor, line: Line, shift: int = 1) -> torch.Tensor:
    """Send ``t`` to the rank ``shift`` places on along the line (wrapping)
    and return what the rank ``shift`` places back sent: the reference's
    ``ppermute`` over [(i, (i + shift) % n)]. Both transfers are posted
    non-blocking before either is waited on (a ring of blocking sends
    deadlocks)."""
    n = line.size
    t = t.contiguous()
    if n == 1:
        return t
    pos = line.ranks.index(dist.get_rank())
    nxt, prv = line.ranks[(pos + shift) % n], line.ranks[(pos - shift) % n]
    nb = t.numel() * t.element_size()
    _count(nb, nb)
    staged = _staged(t, line)
    send = _to_host("ring.out", t) if staged else t
    recv = _pinned("ring.in", t.shape, t.dtype) if staged else \
        torch.empty_like(t)
    reqs = [dist.isend(send, nxt, group=line.group),
            dist.irecv(recv, prv, group=line.group)]
    for r in reqs:
        r.wait()
    return _to_card(recv, t) if staged else recv


def gather(t: torch.Tensor, dst: int, line: Line) -> list | None:
    """Every rank's ``t`` (same shape on every rank) on global rank
    ``dst``, as host tensors in line order; None on the other ranks."""
    me = dist.get_rank()
    nb = t.numel() * t.element_size()
    if line.size == 1:
        return [t.cpu()]
    _count(0 if me == dst else nb, (line.size - 1) * nb if me == dst else 0)
    h = t.contiguous()
    if _staged(h, line):
        h = h.cpu()
        COUNTS["staged"] += nb
    bufs = [torch.empty_like(h) for _ in line.ranks] if me == dst else None
    dist.gather(h, bufs, dst=dst, group=line.group)
    return None if bufs is None else [b.cpu() for b in bufs]


def barrier(line: Line) -> None:
    if line.size > 1:
        dist.barrier(group=line.group)
