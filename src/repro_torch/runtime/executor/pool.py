"""Slot-pool executor: dispatch rounds, overlap host work, harvest tokens.

The pool owns the stacked slot state and advances it one round per
``step_round``. With ``overlap=True`` it pipelines host and device: round
N is dispatched, and only then are round N-1's tokens harvested, so host
work runs while the device computes. Each round's tokens are copied at
dispatch into pinned host memory with ``non_blocking=True`` and an event
is recorded behind the copy; harvest waits on that event alone, never on
the kernels queued after it. ``overlap=False`` harvests the round it just
dispatched. Each harvest appends to ``round_ms`` the wall time from the
start of the round's dispatch to its tokens on the host; with overlap
that includes the next round's dispatch, so it is a token latency and
not the pipelined period; the same time goes to ``metrics.round_ms``
when the pool is given a ``RuntimeMetrics``.

``round_hooks`` are called as ``hook(executor, valid)`` on the host right
before each dispatch (the chaos harness replays modelled stalls into the
measured round series there).

``last_toks`` [n_slots, 1] is the pool's one token buffer for its whole
life: admission writes a slot's first token into it, a fused round (and
its CUDA graph) writes the next tokens into it, and a reference round's
tokens are copied into it, so a captured graph always reads and writes
the same memory.

The reference executor's observability hooks: ``perf`` (an
``obs.perf.PerfMonitor``: roofline attribution at the first harvest and
after a geometry change, achieved rates every harvest), ``spans`` (an
``obs.spans.SpanTracker``: each harvest stamps the measured round period
and the unhidden block time onto the decode slices of the round, matched
by ``RoundHandle.round_idx``) and ``profile`` (each dispatch inside
``torch.profiler.record_function("decode_round")``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.obs.tracer import NULL_RECORDER
from repro_torch.runtime.executor.slotbatch import (blank_state,
                                                    request_batch,
                                                    write_slot)
from repro_torch.runtime.executor.vstep import VStep


@dataclasses.dataclass(frozen=True)
class RoundHandle:
    """An in-flight round: its host token buffer [n_slots, 1], the event
    that marks the copy done (None on the CPU), the (slot, tag) pairs
    active at dispatch, the dispatch time, the round variant dispatched,
    and the VStep dispatch id (the ``round`` arg of this round's
    round.dispatch event; the span flow-arrow anchor)."""
    toks: torch.Tensor
    ready: Any
    slots: tuple[tuple[int, Any], ...]
    t0: float
    variant: str = "reference"
    round_idx: int = 0


class SlotPoolExecutor:
    """Batched execution engine over ``n_slots`` decode slots."""

    def __init__(self, stepper, n_slots: int, *, overlap: bool = True,
                 use_fused: bool | str = "auto",
                 use_graphs: bool | str = "auto", metrics=None,
                 tracer=None, perf=None, profile: bool = False, spans=None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.stepper = stepper
        self.n_slots = int(n_slots)
        self.overlap = bool(overlap)
        self.perf = perf
        self.spans = spans
        self.profile = bool(profile)
        self.vstep = VStep(stepper, use_fused=use_fused,
                           use_graphs=use_graphs)
        self.state = blank_state(stepper, self.n_slots)
        self.last_toks = torch.zeros((self.n_slots, 1), dtype=torch.int32,
                                     device=stepper.device)
        self.active = np.zeros(self.n_slots, bool)
        self.tags: list[Any] = [None] * self.n_slots
        self.round_ms: list[float] = []
        self.metrics = metrics
        self.tracer = tracer if tracer is not None else NULL_RECORDER
        self._pending: RoundHandle | None = None
        self.round_hooks: list[Any] = []

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    def admit(self, slot: int, prompt, valid, tag: Any = None) -> int:
        """Prefill ``prompt`` into ``slot`` and activate it; returns the
        first generated token."""
        logits, row = self.stepper.prefill(request_batch(prompt), valid)
        tok = self.stepper.greedy(logits)                     # [1, 1]
        self.state = write_slot(self.state, slot, row)
        self.last_toks[slot] = tok[0]
        self.active[slot] = True
        self.tags[slot] = tag
        return int(tok[0, 0])

    def evict(self, slot: int):
        self.active[slot] = False
        self.tags[slot] = None

    def evict_all(self):
        self.active[:] = False
        self.tags = [None] * self.n_slots

    def drop_pending(self):
        """Discard the in-flight round (its tokens must not be harvested)."""
        self._pending = None

    def _dispatch(self, valid) -> RoundHandle | None:
        if not self.active.any():
            return None
        t_host = time.perf_counter()
        for hook in self.round_hooks:
            hook(self, valid)
        t0 = time.perf_counter()
        annotate = torch.profiler.record_function("decode_round") \
            if self.profile else contextlib.nullcontext()
        with annotate:
            new_state, toks, _ = self.vstep.round(self.state,
                                                  self.last_toks, valid)
        self.state = new_state
        if toks is not self.last_toks:
            self.last_toks.copy_(toks)
        toks = self.last_toks
        if toks.device.type == "cuda":
            host = torch.empty(toks.shape, dtype=toks.dtype,
                               pin_memory=True)
            host.copy_(toks, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = toks.clone(), None
        occupants = tuple((int(i), self.tags[int(i)])
                          for i in np.flatnonzero(self.active))
        if self.tracer.enabled:
            self.tracer.emit(
                "round.dispatch", track="rounds",
                round=self.vstep.n_dispatches, n_active=len(occupants),
                dead=[int(i) for i in np.flatnonzero(
                    ~np.asarray(valid, bool))],
                wall_args={"dispatch_host_ms":
                           (time.perf_counter() - t_host) * 1e3})
        return RoundHandle(host, ready, occupants, t0,
                           self.vstep.last_variant,
                           round_idx=self.vstep.n_dispatches)

    def _harvest(self, handle: RoundHandle | None
                 ) -> list[tuple[int, Any, int]]:
        if handle is None:
            return []
        t_block = time.perf_counter()
        if handle.ready is not None:
            handle.ready.synchronize()
        t_ready = time.perf_counter()
        period = (t_ready - handle.t0) * 1e3
        block = (t_ready - t_block) * 1e3
        self.round_ms.append(period)
        if self.metrics is not None:
            self.metrics.observe_round_ms(period)
        if self.perf is not None:
            self.perf.observe_round(self, period, handle.variant)
        if self.spans is not None:
            self.spans.on_round_wall(handle.round_idx, period, block)
        if self.tracer.enabled:
            self.tracer.emit(
                "round.harvest", track="rounds", overlap=self.overlap,
                n_harvested=len(handle.slots), wall_dur_ms=period,
                wall_args={"block_ms": block,
                           "host_overlapped_ms": period - block})
        arr = handle.toks.numpy()
        return [(s, tag, int(arr[s, 0])) for s, tag in handle.slots]

    def step_round(self, valid) -> list[tuple[int, Any, int]]:
        """Dispatch one round; return harvested (slot, tag, token) triples
        of this round (overlap off) or of the previous one (overlap on)."""
        prev, self._pending = self._pending, None
        self._pending = self._dispatch(valid)
        if self.overlap:
            return self._harvest(prev)
        out = self._harvest(prev) + self._harvest(self._pending)
        self._pending = None
        return out
