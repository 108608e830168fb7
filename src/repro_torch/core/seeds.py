"""One root seed, many independent deterministic streams.

A chaos run draws randomness in several places — the scheduler's modelled
straggler latencies, the fault injector's churn process, the injected
latency process — and each must be reproducible bit-exact from a SINGLE
root seed while staying independent of how often the *other* streams
draw. Deriving every consumer's rng as ``stream_rng(root, name)`` gives
exactly that: the stream is keyed by (root, name), so adding a draw to
one component never perturbs another, and re-running with the same root
replays the identical fault schedule, latencies, and planner inputs.

Lives in ``repro_torch.core`` (no runtime/faults dependencies) so both
the runtime scheduler and the faults package can use it without a
package cycle; ``repro_torch.faults.seeds`` re-exports it as part of the
chaos API. A copy of the reference package's ``core/seeds.py``: the same
(root, name) gives the same numpy stream bit for bit.
"""
from __future__ import annotations

import zlib

import numpy as np


def stream_seed(root: int, name: str) -> np.random.SeedSequence:
    """A SeedSequence for the named stream under ``root``."""
    return np.random.SeedSequence(
        [int(root) & 0xFFFFFFFF, zlib.crc32(name.encode("utf-8"))])


def stream_rng(root: int, name: str) -> np.random.Generator:
    """An independent Generator for the named stream under ``root``.

    Same (root, name) -> bit-identical draw sequence; different names (or
    roots) -> statistically independent streams.
    """
    return np.random.default_rng(stream_seed(root, name))
