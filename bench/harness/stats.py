"""Percentiles as the benchmark reports them."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float | None:
    """The q-th percentile (0..100) of all ``values`` by linear
    interpolation between closest ranks (numpy's default); None when
    there is no value."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values) -> float | None:
    return percentile(values, 50.0)
