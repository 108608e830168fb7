"""Root-seed stream derivation for the chaos harness.

The implementation lives in ``repro_torch.core.seeds`` (dependency-free, so
the runtime scheduler can share it without a runtime <-> faults package
cycle); this module re-exports it as part of the faults API.
"""
from repro_torch.core.seeds import stream_rng, stream_seed

__all__ = ["stream_rng", "stream_seed"]
