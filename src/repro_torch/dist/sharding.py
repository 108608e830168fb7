"""Layout rules: map every model-zoo param/state tree onto a mesh of ranks.

Mesh axes (the reference's):
  ``model``  the tensor-parallel axis. Its size IS the code's T: coded GEMM
             output shard i (columns [i*m_l, (i+1)*m_l) of ``w``) and folded
             parity slot i both live on model-rank i, so a CDC shard maps to
             a real process and ``valid[i]`` names model-rank i.
  ``data``   batch/FSDP axis (weights sharded over it when ``fsdp="data"``).
  ``pod``    optional outer axis: extra batch parallelism for train/serve,
             and the stage axis for ``dist.pipeline``.

A spec is a tuple with one entry a dim: an axis name, a tuple of axis names
(the dim split over their product, the first outermost) or None
(replicated), entry for entry what the reference's ``PartitionSpec`` holds
(a one-name tuple is the name, as ``PartitionSpec`` normalises it). A dim
is only sharded when the axis exists in the mesh AND divides it evenly;
otherwise that dim falls back to replicated, so the specs are total over
every (arch x mesh) cell including ragged smoke shapes.

``Mesh`` is metadata (axis names, sizes, the global rank at each mesh
position) until a collective asks it for a process group: ``group(axes)``
then creates, once, one ``torch.distributed`` group for every line of the
mesh along those axes (every rank creates every line's group, in the same
order, as ``new_group`` requires) and returns this rank's. In place of
the reference's ``NamedSharding`` placement, ``shard_params`` /
``local_shard`` take one rank's block of each leaf (what ``shard_map``'s
``in_specs`` hand a device) and ``gather_params`` is their inverse.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import named_leaves, tree_map, unflatten

__all__ = ["Mesh", "Line", "param_specs", "state_specs", "batch_spec",
           "batch_axes", "shard_params", "local_shard", "gather_params",
           "block_index", "assemble", "paired_leaves"]

# parent-dict names of row-parallel (input-split) GEMMs: first dim over
# `model` (megatron row layout; never coded — paper Table 1)
_ROW_PARALLEL = frozenset({"wo", "w2", "down", "out_proj"})
# stacked-layer containers (leaves carry a leading L axis)
_STACKED = frozenset({"layers", "enc_layers", "dec_layers"})
# MoE expert slabs [E, ., .]: expert axis over `model` (expert parallelism)
_EXPERT = frozenset({"we1", "we2", "we3"})


@dataclasses.dataclass
class Line:
    """The ranks of one mesh line (global ranks, in axis order) and the
    process group that joins them (None for a line of one rank)."""

    ranks: tuple[int, ...]
    group: Any = None

    @property
    def size(self) -> int:
        return len(self.ranks)


class Mesh:
    """A logical device mesh over the ranks of a ``torch.distributed``
    world: ``axis_names``, ``shape`` (axis -> size, in axis order) and
    ``devices`` (the global rank at each mesh position, row-major)."""

    def __init__(self, shape, axis_names):
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names) or len(set(axis_names)) != \
                len(axis_names):
            raise ValueError(f"mesh shape {shape} / axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.devices = np.arange(math.prod(shape)).reshape(shape)
        self._lines: dict[tuple, Line] = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: int) -> dict[str, int]:
        """The mesh position of global rank ``rank``: axis -> index."""
        idx = np.unravel_index(int(rank), self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def lines(self, axes) -> list[tuple[int, ...]]:
        """Every line of the mesh along ``axes`` (a name or a tuple of
        names; the first outermost), in a fixed order: the global ranks
        that differ only in those axes' coordinates."""
        axes = _names(axes)
        rest = [a for a in self.axis_names if a not in axes]
        order = [self.axis_names.index(a) for a in rest + list(axes)]
        d = np.transpose(self.devices, order)
        n = math.prod(self.shape[a] for a in axes)
        return [tuple(int(r) for r in row) for row in d.reshape(-1, n)]

    def group(self, axes) -> Line:
        """This rank's line along ``axes``, with its process group. The
        first call for ``axes`` creates the groups of every line; all ranks
        of the world make it at the same point of their programs."""
        key = _names(axes)
        if key not in self._lines:
            if dist.get_world_size() != self.size:
                raise ValueError(f"{self} covers {self.size} ranks; the "
                                 f"world has {dist.get_world_size()}")
            me = dist.get_rank()
            for line in self.lines(key):
                g = dist.new_group(list(line)) if len(line) > 1 else None
                if me in line:
                    self._lines[key] = Line(line, g)
        return self._lines[key]


def _names(axes) -> tuple[str, ...]:
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


def _entry(axes):
    """A spec entry as ``PartitionSpec`` holds it: a one-name tuple is the
    name."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes carrying the batch dimension, outermost first."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_spec(mesh) -> tuple:
    """Spec for [B, ...] batch inputs (tokens/frames): B over pod+data."""
    axes = batch_axes(mesh)
    return (_entry(axes),) if axes else ()


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    return math.prod(mesh.shape[a] for a in _names(axis))


def _fit(spec: tuple, shape: tuple, mesh) -> tuple:
    """Drop any axis that is absent from the mesh or does not divide its
    dim; pad/trim the spec to the leaf's rank."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, spec[:len(shape)]):
        if axis is None:
            out.append(None)
            continue
        if all(a in mesh.axis_names for a in _names(axis)) \
                and dim % _axis_size(mesh, axis) == 0:
            out.append(_entry(axis))
        else:
            out.append(None)
    return tuple(out)


def _param_rule(names: list[str], shape: tuple, mesh, fsdp):
    """Base spec (before the stacked-L prefix) for one param leaf."""
    name = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    tp = mesh.shape["model"] if "model" in mesh.axis_names else 1

    if name == "w":
        if parent == "router":
            return ()                       # replicated (routing is local)
        if parent in _ROW_PARALLEL:
            return ("model", fsdp)          # [k, m]: input dim sharded
        return (fsdp, "model")              # column-parallel: T output shards
    if name == "cdc":
        # folded parity slots [T, k, r*w]: slot axis over `model` so slot d
        # rides on the same rank as data shard d (a whole-rank failure
        # erases exactly its own slices). Dedicated parity [r, k, m_l]: the
        # parity columns instead (the +r workers live off the mesh). The
        # layouts are told apart by the leading dim (T vs r); when they
        # collide (dedicated with r == T) the folded placement wins.
        if len(shape) >= 3 and shape[-3] == tp:
            return ("model", fsdp, None)
        return (None, fsdp, "model")
    if name == "embed":
        return ("model", fsdp)              # vocab rows over `model`
    if name in _EXPERT:
        return ("model", fsdp, None)        # EP: expert slab per rank
    return ()                               # norms, biases, scalars, ...


def param_specs(params, mesh, *, fsdp: str | None = "data"):
    """Spec tree for a model param tree (tensors, arrays or anything with
    ``.shape``). ``fsdp=None`` replicates weights over the data axis (the
    serving layout). Leaf names are the reference's (``tree.named_leaves``:
    dict keys, ``#i`` for list items)."""
    specs = []
    for name, leaf in named_leaves(params):
        parts = name.split("/")
        shape = tuple(leaf.shape)
        stacked = any(n in _STACKED for n in parts)
        base = _param_rule(parts, shape[1:] if stacked else shape, mesh,
                           fsdp)
        if stacked:
            base = (None,) + tuple(base)
        specs.append(_fit(base, shape, mesh))
    return unflatten(params, specs)


def state_specs(state, mesh):
    """Decode-state layout: batch dim over pod+data, bookkeeping replicated.

    KV caches / SSM states under the stacked containers carry a leading L
    axis (batch is dim 1); xLSTM's per-block list states put batch at dim
    0. ``len``/``pos`` counters are replicated.
    """
    axes = batch_axes(mesh)
    specs = []
    for name, leaf in named_leaves(state):
        parts = name.split("/")
        shape = tuple(leaf.shape)
        if not axes or parts[-1] in ("len", "pos") or len(shape) < 2:
            specs.append(())
            continue
        b_dim = 0 if parts[0] == "blocks" else 1
        spec = [None] * len(shape)
        spec[b_dim] = axes
        specs.append(_fit(tuple(spec), shape, mesh))
    return unflatten(state, specs)


# ------------------------------------------------------------ blocks ----

def block_index(spec: tuple, mesh, rank: int) -> list[tuple[int, int]]:
    """(part, parts) of each dim of a leaf under ``spec`` on ``rank``:
    the dim is cut into ``parts`` equal blocks and the rank holds block
    ``part`` (row-major over the entry's axes, the first outermost)."""
    c = mesh.coords(rank)
    out = []
    for axis in spec:
        part, parts = 0, 1
        if axis is not None:
            for a in _names(axis):
                part = part * mesh.shape[a] + c[a]
                parts *= mesh.shape[a]
        out.append((part, parts))
    return out


def local_shard(leaf, spec: tuple, mesh, rank: int):
    """``rank``'s block of ``leaf`` (a tensor or a numpy array, e.g. a
    memory map) under ``spec``: a view, nothing copied."""
    out = leaf
    for dim, (part, parts) in enumerate(block_index(spec, mesh, rank)):
        if parts == 1:
            continue
        n = leaf.shape[dim] // parts
        if isinstance(out, torch.Tensor):
            out = out.narrow(dim, part * n, n)
        else:
            out = out[(slice(None),) * dim + (slice(part * n,
                                                    (part + 1) * n),)]
    return out


def shard_params(params, mesh, rank: int, *, fsdp: str | None = "data",
                 specs=None):
    """Every leaf's block for ``rank`` (views of ``params``), under
    ``specs`` (``param_specs(params, mesh, fsdp=fsdp)`` when None)."""
    specs = specs if specs is not None else param_specs(params, mesh,
                                                        fsdp=fsdp)
    return tree_map(lambda leaf, s: local_shard(leaf, s, mesh, rank),
                    params, specs)


def paired_leaves(tree, specs) -> list[tuple[Any, tuple]]:
    """(leaf, spec) in the reference's leaf order (``tree`` decides what a
    leaf is; a spec is a tuple, so ``specs`` cannot)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in paired_leaves(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in paired_leaves(v, specs[i])]
    return [(tree, tuple(specs))]


def assemble(blocks: list, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf from every rank's block (``blocks[rank]``), each
    block taken from the first rank that holds it."""
    first = blocks[0]
    n_dims = first.dim()
    spec = tuple(spec) + (None,) * (n_dims - len(spec))
    parts = [p for _, p in block_index(spec, mesh, 0)]
    shape = [first.shape[d] * parts[d] for d in range(n_dims)]
    out = first.new_empty(shape)
    seen = set()
    for rank, blk in enumerate(blocks):
        idx = tuple(p for p, _ in block_index(spec, mesh, rank))
        if idx in seen:
            continue
        seen.add(idx)
        view = out
        for d, p in enumerate(idx):
            if parts[d] > 1:
                view = view.narrow(d, p * blk.shape[d], blk.shape[d])
        view.copy_(blk)
    return out


def gather_params(local, mesh, specs):
    """The inverse of ``shard_params``: every leaf whole on every rank,
    from each rank's block (one all-gather over the world a sharded leaf;
    replicated leaves are returned as they are)."""
    from repro_torch.dist import comm
    world = comm.world_line()
    out = []
    for blk, spec in paired_leaves(local, specs):
        if all(a is None for a in spec):
            out.append(blk)
            continue
        blocks = comm.all_gather(blk.contiguous(), world)
        out.append(assemble(list(blocks.unbind(0)), spec, mesh))
    return unflatten(local, out)
