"""Seeded draws that give every seed the same sizes, in another order.

``Sequence``: a stream of sizes at the quantiles frac(offset + j * step)
for j = 0, 1, ... (a low-discrepancy sequence: any stretch of it covers
the distribution evenly). The closed loop deals the same streams to its
clients in an order drawn from the seed, so two seeds differ in which
request gets which size and when, and hardly in how much work any
stretch of the mix holds."""
from __future__ import annotations

import math
import statistics

import numpy as np

_NORMAL = statistics.NormalDist()


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), *stream])


def quantile(spec: dict, u: float) -> float:
    """The u-quantile of a length distribution spec: {"dist":
    "lognormal", "median", "sigma"} or {"dist": "uniform", "min", "max"}
    (whole numbers, both ends included), clipped to ["min", "max"]."""
    lo, hi = spec["min"], spec["max"]
    if spec["dist"] == "lognormal":
        x = spec["median"] * math.exp(spec["sigma"] * _NORMAL.inv_cdf(u))
        return float(min(max(round(x), lo), hi))
    if spec["dist"] == "uniform":
        return float(min(lo + math.floor(u * (hi - lo + 1)), hi))
    raise ValueError(f"unknown distribution {spec['dist']!r}")


GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0
SILVER = math.sqrt(2.0) - 1.0


class Sequence:
    """Sizes at the quantiles frac(offset + j * step), j = 0, 1, ..."""

    def __init__(self, spec: dict, offset: float, step: float = GOLDEN):
        self.spec, self.offset, self.step = spec, float(offset), float(step)

    def u(self, j: int) -> float:
        return (self.offset + j * self.step) % 1.0

    def __getitem__(self, j: int) -> int:
        return int(quantile(self.spec, self.u(j)))


def residual(spec: dict, u: np.ndarray, w: np.ndarray,
             grid: int = 4096) -> np.ndarray:
    """Remaining lengths of requests found in progress by an observer
    arriving at a random time, at quantiles ``u`` of the length-biased
    distribution (a length drawn with probability in proportion to it)
    and with the shares ``w`` of it left (at least 1)."""
    lengths = np.array([quantile(spec, (i + 0.5) / grid)
                        for i in range(grid)])
    cdf = np.cumsum(lengths) / lengths.sum()
    picked = lengths[np.minimum(np.searchsorted(cdf, u), grid - 1)]
    return np.maximum(1, np.ceil(w * picked)).astype(np.int64)


def prompt(seed: int, index: int, length: int, vocab: int) -> np.ndarray:
    """The token ids of request ``index``: the same for a seed whatever
    the timing."""
    return rng(seed, 1, index).integers(0, vocab, int(length))
