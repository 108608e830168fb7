"""Failure & straggler models (paper §2 Fig. 1, §6.2 Fig. 14-16): a copy
of the reference package's ``core/failure.py``.

Failures are modelled as an *erasure channel*: a boolean validity mask
over shard outputs. The serving layer and
benchmarks draw masks / latencies from the models here; the recovery math in
``coding.decode_outputs`` consumes the masks.

Latency model: the paper's Fig. 1 arrival histogram (RPis over WiFi) is
heavy-tailed past the 50 ms compute floor. We model per-shard response time as
``floor + lognormal`` which reproduces that shape; first-T-of-(T+r) order
statistics then quantify straggler mitigation exactly as §6.2 does.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class StragglerModel:
    """floor + LogNormal(mu, sigma) per-shard latency, iid across shards."""

    floor_ms: float = 50.0     # single-device compute time in the paper
    mu: float = 3.0            # lognormal location (of the tail part, ms)
    sigma: float = 1.0         # heavy tail: ~34% of arrivals past 2x floor

    def sample(self, rng: np.random.Generator, shape) -> np.ndarray:
        return self.floor_ms + rng.lognormal(self.mu, self.sigma, size=shape)


def sample_erasures(rng: np.random.Generator, n_shards: int, p_fail: float,
                    max_erasures: int) -> np.ndarray:
    """Validity mask with iid failures, clipped to the decodable budget."""
    fail = rng.random(n_shards) < p_fail
    if fail.sum() > max_erasures:
        # keep only the first `max_erasures` failures (beyond-budget failures
        # fall back to the paper's degraded-redistribution path)
        idx = np.flatnonzero(fail)[max_erasures:]
        fail[idx] = False
    return ~fail


def request_latency(times: np.ndarray, need: int) -> np.ndarray:
    """Latency of a coded request: the `need`-th order statistic.

    times: [..., n_shards] per-shard response times. With r parity shards the
    combiner proceeds after the fastest T = need arrivals (paper §6.2); the
    uncoded system waits for max(times) over its T shards.
    """
    return np.sort(times, axis=-1)[..., need - 1]


def mitigation_improvement(model: StragglerModel, n_devices: int,
                           n_parity: int = 1, n_trials: int = 20000,
                           seed: int = 0) -> dict:
    """Reproduces Fig. 16b: % latency improvement of first-T-of-(T+r) over
    wait-for-all-T, at equal shard work."""
    rng = np.random.default_rng(seed)
    base = model.sample(rng, (n_trials, n_devices))
    coded = model.sample(rng, (n_trials, n_devices + n_parity))
    lat_base = request_latency(base, n_devices)            # max of T
    lat_coded = request_latency(coded, n_devices)          # T-th of T+r
    return {
        "n_devices": n_devices,
        "mean_uncoded_ms": float(lat_base.mean()),
        "mean_coded_ms": float(lat_coded.mean()),
        "p99_uncoded_ms": float(np.percentile(lat_base, 99)),
        "p99_coded_ms": float(np.percentile(lat_coded, 99)),
        "mean_improvement_pct":
            float(100 * (1 - lat_coded.mean() / lat_base.mean())),
        "p99_improvement_pct":
            float(100 * (1 - np.percentile(lat_coded, 99)
                         / np.percentile(lat_base, 99))),
    }


def coverage_2mr(n_model_parallel: int, n_other: int) -> dict:
    """Paper §6.3 / Fig. 17 economics: devices needed to tolerate 1 failure.

    2MR duplicates every device (linear). CDC covers all n_model_parallel
    devices of a coded layer with ONE extra device (constant); remaining
    devices still need 2MR. Returns extra-device counts and coverage ratios.
    """
    total = n_model_parallel + n_other
    extra_2mr = total                      # duplicate everything
    extra_cdc = 1 + n_other                # 1 parity + 2MR for the rest
    return {
        "devices": total,
        "extra_2mr": extra_2mr,
        "extra_cdc_2mr": extra_cdc,
        "hw_cost_2mr": (total + extra_2mr) / total,          # 2.0x
        "hw_cost_cdc_2mr": (total + extra_cdc) / total,      # (1 + 1/N) on MP part
    }


def coverage_at_budget(n_model_parallel_layers: list[int], n_other: int,
                       extra_budget: int) -> dict:
    """Coverage fraction achievable with a fixed number of extra devices
    (the Fig. 17 bar charts): CDC covers a whole coded layer per extra
    device; 2MR covers one device per extra device."""
    mp_total = sum(n_model_parallel_layers)
    total = mp_total + n_other
    cov_2mr = min(extra_budget, total) / total
    covered = 0
    budget = extra_budget
    # spend on model-parallel layers first (best coverage per device)
    for n in sorted(n_model_parallel_layers, reverse=True):
        if budget <= 0:
            break
        covered += n
        budget -= 1
    covered += min(budget, n_other)
    cov_cdc = min(covered, total) / total
    return {"coverage_2mr": cov_2mr, "coverage_cdc_2mr": cov_cdc,
            "extra_budget": extra_budget, "devices": total}
