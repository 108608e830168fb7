"""Seeded weights, made by the benchmark on the device.

The tree has the layout the port's set-up path takes (its ``init`` on
the meta device gives the shapes; no value of it is used): every leaf is
a view into one flat buffer filled by a ``torch.Generator`` on the
device in a few large calls, then scaled in place. A coded leaf's parity
slot is left empty (``None``) for the port's offline encode to fill.
"""
from __future__ import annotations

import math

import torch

ALIGN = 64                 # elements: every leaf starts on 256 bytes
CHUNK = 1 << 30            # elements a generator call fills


def _leaves(node, path=()):
    if isinstance(node, dict):
        for key, val in node.items():
            if key != "cdc":
                yield from _leaves(val, path + (key,))
    elif isinstance(node, (list, tuple)):
        for i, val in enumerate(node):
            yield from _leaves(val, path + (i,))
    else:
        yield path, tuple(node.shape)


def _rebuild(meta, views, path=()):
    if isinstance(meta, dict):
        return {key: (None if key == "cdc"
                      else _rebuild(val, views, path + (key,)))
                for key, val in meta.items()}
    if isinstance(meta, (list, tuple)):
        return type(meta)(_rebuild(v, views, path + (i,))
                          for i, v in enumerate(meta))
    return views[path]


def _scale(path, leaf: torch.Tensor, vocab: int):
    name = path[-1]
    if name == "g":                       # norm gains near 1
        leaf.mul_(0.1).add_(1.0)
    elif name == "embed":
        pass                              # unit normal rows
    else:                                 # products: 1 / sqrt(fan in)
        leaf.mul_(1.0 / math.sqrt(leaf.shape[-2]))
    if path[0] == "lm_head" and leaf.shape[-1] > vocab:
        leaf[..., vocab:] = 0.0           # the code's padded columns


def make(model, seed: int, device: torch.device, vocab: int):
    """The raw parameter tree of ``model`` from ``seed``, float32 on
    ``device``. Returns (tree, flat buffer)."""
    meta = model.init(device="meta")
    leaves = list(_leaves(meta))
    offsets, total = [], 0
    for _, shape in leaves:
        offsets.append(total)
        total += -(-math.prod(shape) // ALIGN) * ALIGN
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    for a in range(0, total, CHUNK):
        flat[a:a + CHUNK].normal_(generator=gen)
    views = {}
    for (path, shape), off in zip(leaves, offsets):
        leaf = flat[off:off + math.prod(shape)].view(shape)
        _scale(path, leaf, vocab)
        views[path] = leaf
    return _rebuild(meta, views), flat
