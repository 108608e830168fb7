"""Runtime telemetry: counters, bounded histograms, queue-depth stats.

A copy of the reference package's ``runtime/metrics.py``; the snapshot
has the reference's keys, the ``perf`` gauges of ``obs.perf`` among them.

Memory is bounded regardless of run length: latency, queueing, TTFT and
measured round times are fixed-bucket log-spaced histograms (exact
n/mean/max running aggregates + bucket counts) with a deterministic
bounded reservoir for percentiles. Up to the reservoir size the
percentiles are exact; beyond it they are reservoir estimates,
reproducible across replays because sampling uses a per-instance seeded
stream (Vitter's algorithm R), never global randomness.

Counter names are a closed registry: ``count()`` on an unknown name
raises instead of silently creating a phantom counter; extensions go
through an explicit ``register()``.
"""
from __future__ import annotations

import json
from collections import deque

import numpy as np

_COUNTERS = (
    "requests_submitted",
    "requests_admitted",
    "requests_completed",
    "requests_requeued",
    "requests_shed",
    "decode_rounds",
    "tokens_generated",
    "erasures_recovered",
    "beyond_budget_failures",
    "shards_healed",
    "parity_reencodes",
    "faults_injected",
    "replans",
)

#: default reservoir bound — small runs (every test/benchmark in CI) stay
#: exact; week-long runs stay O(1) in memory.
RESERVOIR_SIZE = 4096
#: log-spaced bucket upper bounds, 10 µs .. 1000 s: covers fused-round
#: microseconds through chaos-storm requeue latencies.
BUCKET_BOUNDS = tuple(float(b) for b in np.geomspace(1e-2, 1e6, 49))


class Histogram:
    """Fixed-bucket histogram + deterministic bounded reservoir.

    ``observe`` is O(log buckets); ``n``/``total``/``vmax`` are exact
    running aggregates, ``percentile`` comes from the reservoir (exact
    while ``n <= reservoir_size``). ``buckets()`` yields cumulative
    (upper_bound, count) pairs in Prometheus ``le`` convention.
    """

    def __init__(self, reservoir_size: int = RESERVOIR_SIZE,
                 bounds: tuple = BUCKET_BOUNDS, seed: int = 0):
        if reservoir_size < 1:
            raise ValueError("reservoir_size must be >= 1")
        self.bounds = np.asarray(bounds, np.float64)
        if self.bounds.ndim != 1 or not np.all(np.diff(self.bounds) > 0):
            raise ValueError("bounds must be strictly increasing 1-D")
        self.counts = np.zeros(self.bounds.size + 1, np.int64)  # +overflow
        self.reservoir_size = int(reservoir_size)
        self._res = np.empty(self.reservoir_size, np.float64)
        self._rng = np.random.default_rng(seed)
        self.n = 0
        self.total = 0.0
        self.vmax = -np.inf
        self.vmin = np.inf

    def observe(self, x: float):
        x = float(x)
        self.n += 1
        self.total += x
        self.vmax = max(self.vmax, x)
        self.vmin = min(self.vmin, x)
        self.counts[int(np.searchsorted(self.bounds, x, side="left"))] += 1
        if self.n <= self.reservoir_size:
            self._res[self.n - 1] = x
        else:
            # Vitter's algorithm R: uniform over the stream, deterministic
            # per instance (seeded stream, no global RNG)
            j = int(self._rng.integers(self.n))
            if j < self.reservoir_size:
                self._res[j] = x

    # ------------------------------------------------------------- read ----
    def __len__(self) -> int:
        return self.n

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def _sample(self) -> np.ndarray:
        return self._res[:min(self.n, self.reservoir_size)]

    def percentile(self, q: float) -> float:
        if self.n == 0:
            raise ValueError("empty histogram")
        return float(np.percentile(self._sample(), q))

    def buckets(self):
        """Cumulative (le, count) pairs; the last le is +Inf."""
        cum = np.cumsum(self.counts)
        for le, c in zip(self.bounds, cum[:-1]):
            yield float(le), int(c)
        yield float("inf"), int(cum[-1])

    def dist(self) -> dict:
        """The snapshot dict — keys unchanged from the unbounded-list
        implementation so BENCH_*.json schemas and CI assertions hold."""
        if self.n == 0:
            return {"n": 0}
        return {
            "n": self.n,
            "mean_ms": self.mean,
            "p50_ms": self.percentile(50),
            "p99_ms": self.percentile(99),
            "max_ms": float(self.vmax),
        }


class QueueDepthStats:
    """Running queue-depth aggregates (formerly an unbounded
    (t_ms, depth) list): exact sample count / mean / max plus the last
    observed depth for live gauges."""

    def __init__(self):
        self.n = 0
        self.total = 0
        self.vmax = 0
        self.last = 0

    def sample(self, t_ms: float, depth: int):
        depth = int(depth)
        self.n += 1
        self.total += depth
        self.vmax = max(self.vmax, depth)
        self.last = depth

    def snapshot(self) -> dict:
        return {
            "samples": self.n,
            "mean": self.total / self.n if self.n else 0.0,
            "max": self.vmax,
        }


class RuntimeMetrics:
    #: plans kept verbatim for the snapshot's r-series; bounded so a
    #: perpetual server cannot grow it without limit
    PLAN_LOG_BOUND = 4096

    def __init__(self, reservoir_size: int = RESERVOIR_SIZE):
        self.counters: dict[str, int] = {k: 0 for k in _COUNTERS}
        self.latencies_ms = Histogram(reservoir_size, seed=1)
        self.queueing_ms = Histogram(reservoir_size, seed=2)
        self.ttft_ms = Histogram(reservoir_size, seed=3)
        self.round_ms = Histogram(reservoir_size, seed=4)  # MEASURED rounds
        self.queue_depth = QueueDepthStats()
        # per-cause shed breakdown (reason -> count); the total stays in
        # counters["requests_shed"] so existing BENCH schemas are unchanged
        self.shed_causes: dict[str, int] = {}
        self.plan_log: deque[dict] = deque(maxlen=self.PLAN_LOG_BOUND)
        self.start_ms: float | None = None
        self.end_ms: float | None = None
        # roofline-anchored perf gauges (obs.perf merges static attribution
        # + per-round achieved rates here; empty when perf accounting is
        # off) — exported via prometheus_text as repro_perf_* gauges
        self.perf: dict = {}

    # ------------------------------------------------------------ write ----
    def register(self, name: str):
        """Add a counter to the registry (extension point). Registering
        an existing name is a no-op, never a reset."""
        self.counters.setdefault(name, 0)

    def count(self, name: str, n: int = 1):
        if name not in self.counters:
            raise KeyError(
                f"unknown counter {name!r}: register() it first "
                f"(known: {sorted(self.counters)})")
        self.counters[name] += n

    def count_shed(self, cause: str):
        """One shed request, attributed to a cause (the admission queue's
        ``shed_reason``). Keeps the aggregate counter in step."""
        self.count("requests_shed")
        self.shed_causes[cause] = self.shed_causes.get(cause, 0) + 1

    def observe_request(self, latency_ms: float, queueing_ms: float,
                        ttft_ms: float | None = None):
        self.latencies_ms.observe(latency_ms)
        self.queueing_ms.observe(queueing_ms)
        if ttft_ms is not None:
            self.ttft_ms.observe(ttft_ms)

    def observe_round_ms(self, wall_ms: float):
        """Measured wall-clock time of one decode round (dispatch->ready,
        or the pipelined round period under executor overlap) — the
        real-hardware series reported alongside the modelled
        StragglerModel numbers that drive the simulated clock."""
        self.round_ms.observe(wall_ms)

    def sample_queue_depth(self, t_ms: float, depth: int):
        self.queue_depth.sample(t_ms, depth)

    def observe_plan(self, plan: dict, applied: bool):
        """One adaptive-redundancy planner decision (window boundary)."""
        self.plan_log.append({"applied": bool(applied), **plan})

    def set_perf(self, values: dict):
        """Merge perf-attribution gauges (latest-value semantics)."""
        self.perf.update(values)

    def mark(self, t_ms: float):
        if self.start_ms is None:
            self.start_ms = float(t_ms)
        self.end_ms = float(t_ms)

    # ------------------------------------------------------------- read ----
    @property
    def elapsed_ms(self) -> float:
        if self.start_ms is None or self.end_ms is None:
            return 0.0
        return self.end_ms - self.start_ms

    def snapshot(self) -> dict:
        elapsed_s = self.elapsed_ms / 1e3
        return {
            "counters": dict(self.counters),
            "shed_causes": dict(self.shed_causes),
            "elapsed_ms": self.elapsed_ms,
            "throughput": {
                "tokens_per_s": (self.counters["tokens_generated"] / elapsed_s
                                 if elapsed_s > 0 else None),
                "requests_per_s": (
                    self.counters["requests_completed"] / elapsed_s
                    if elapsed_s > 0 else None),
            },
            "request_latency": self.latencies_ms.dist(),
            "queueing_delay": self.queueing_ms.dist(),
            "ttft": self.ttft_ms.dist(),
            "round_latency_measured": self.round_ms.dist(),
            "queue_depth": self.queue_depth.snapshot(),
            "perf": dict(self.perf),
            "planner": {
                "n_plans": len(self.plan_log),
                "r_series": [[p["t_ms"], p["r"]] for p in self.plan_log],
                "final_r": (self.plan_log[-1]["r"] if self.plan_log
                            else None),
                "max_r": (max(p["r"] for p in self.plan_log)
                          if self.plan_log else None),
                "plans": list(self.plan_log),
            },
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)
