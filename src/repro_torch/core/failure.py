"""Straggler latency model (paper §6.2): a copy of the reference's
``StragglerModel`` and ``request_latency``, which the stepper uses."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class StragglerModel:
    """floor + LogNormal(mu, sigma) per-shard latency, iid across shards."""

    floor_ms: float = 50.0
    mu: float = 3.0
    sigma: float = 1.0

    def sample(self, rng: np.random.Generator, shape) -> np.ndarray:
        return self.floor_ms + rng.lognormal(self.mu, self.sigma, size=shape)


def request_latency(times: np.ndarray, need: int) -> np.ndarray:
    """Latency of a coded request: the ``need``-th order statistic of the
    per-shard response times [..., n_shards]."""
    return np.sort(times, axis=-1)[..., need - 1]
