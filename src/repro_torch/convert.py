"""Carry parameters of the reference package over to the port.

``params_from_jax`` takes the reference's params as a nested dict of numpy
arrays (what ``jax.tree.map(np.asarray, params)`` gives) and returns the
port's params on ``device``. Base weights are carried over as they are;
parity leaves are recomputed by the port's own ``encode_tree`` from them,
so at padded head counts the parity covers the padded columns as the
reference's base weights hold them (zeros), not the reference's ``init``
parity, which was encoded before they were zeroed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import TPCtx, encode_tree


def params_from_jax(tree, ctx: TPCtx, device: str | torch.device = "cuda"):
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return torch.as_tensor(np.array(node), device=dev)

    return encode_tree(walk(tree), ctx)
