"""Mesh construction: metadata meshes over the ranks of a world.

Building a mesh touches no process group (``dist.sharding.Mesh`` makes its
groups when a collective first asks), so these run anywhere, before or
without ``torch.distributed.init_process_group``.
"""
from __future__ import annotations

from repro_torch.dist.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_test_mesh(data: int = 2, model: int = 4,
                   pod: int | None = None) -> Mesh:
    """Small meshes for worlds of a few ranks."""
    if pod:
        return Mesh((pod, data, model), ("pod", "data", "model"))
    return Mesh((data, model), ("data", "model"))
