"""Token data pipeline: synthetic + memory-mapped corpora, host-sharded.

The port's own copy of the reference's pipeline (numpy only): the same
(seed, step, host_index) gives the same batch, to the bit.

Deterministic and restart-safe: the stream is a pure function of
(seed, step), so resuming from a checkpoint at step N reproduces exactly the
batches the failed run would have seen — the data-side half of
checkpoint/restart fault tolerance. Hosts read only their own batch shard
(data-parallel slicing by host index) so the input path scales with the
fleet instead of funnelling through one reader.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    kind: str = "synthetic"       # synthetic | memmap
    path: str | None = None       # memmap: flat uint16/uint32 token file
    host_index: int = 0
    host_count: int = 1

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.host_count == 0
        return self.global_batch // self.host_count


def _synthetic_batch(cfg: DataConfig, step: int) -> np.ndarray:
    """Markov-ish synthetic tokens (not uniform noise, so loss can drop)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_index]))
    b, s = cfg.host_batch, cfg.seq_len
    base = rng.integers(0, cfg.vocab, size=(b, 1), dtype=np.int64)
    drift = rng.integers(-8, 9, size=(b, s), dtype=np.int64).cumsum(1)
    toks = (base + np.abs(drift)) % cfg.vocab
    return toks.astype(np.int32)


class MemmapDataset:
    """Flat binary token file, sampled with a deterministic per-step rng."""

    def __init__(self, cfg: DataConfig):
        assert cfg.path and os.path.exists(cfg.path), cfg.path
        self.cfg = cfg
        self.tokens = np.memmap(cfg.path, dtype=np.uint16, mode="r")
        assert len(self.tokens) > cfg.seq_len + 1, "corpus too small"

    def batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_index]))
        starts = rng.integers(0, len(self.tokens) - cfg.seq_len - 1,
                              size=cfg.host_batch)
        out = np.stack([self.tokens[s:s + cfg.seq_len] for s in starts])
        return (out.astype(np.int64) % cfg.vocab).astype(np.int32)


def make_stream(cfg: DataConfig, start_step: int = 0
                ) -> Iterator[dict[str, np.ndarray]]:
    ds = MemmapDataset(cfg) if cfg.kind == "memmap" else None
    step = start_step
    while True:
        toks = ds.batch(step) if ds else _synthetic_batch(cfg, step)
        yield {"tokens": toks}
        step += 1


def write_corpus(path: str, vocab: int, n_tokens: int, seed: int = 0):
    """Generate a small corpus file (for the memmap path & examples)."""
    rng = np.random.default_rng(seed)
    # repeated phrases => learnable structure
    phrase = rng.integers(0, vocab, size=257, dtype=np.uint16)
    reps = n_tokens // len(phrase) + 1
    toks = np.tile(phrase, reps)[:n_tokens]
    noise = rng.random(n_tokens) < 0.05
    toks[noise] = rng.integers(0, vocab, noise.sum(), dtype=np.uint16)
    toks.astype(np.uint16).tofile(path)
