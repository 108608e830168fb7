"""Stack decode-slot states into one slot-batched state.

Every decode-state leaf is laid out [L(layers), B(slots), ...], so the
batch axis IS the slot axis (``SLOT_AXIS == 1``). With the per-row cache
each row carries its own KV length and positions, so rows decode at
independent positions in one round. Admission overwrites one row in place.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

SLOT_AXIS = 1


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def request_batch(prompt) -> dict:
    """One request's prefill batch: [1, S] int32 tokens."""
    return {"tokens": np.asarray(prompt, np.int32)[None, :]}


def blank_state(stepper, n_slots: int) -> Any:
    """A zero-filled stacked per-row state with ``n_slots`` rows. Admission
    overwrites a row wholesale before it is read; never-admitted rows step
    through decode harmlessly (as in the reference, whose blank state is
    zeros of the same shapes)."""
    state = stepper.model.init_decode(stepper.params, n_slots,
                                      stepper.max_len, stepper.cache_dtype)
    return _map(torch.zeros_like, state)


def write_slot(stacked: Any, idx: int, row: Any, axis: int = SLOT_AXIS
               ) -> Any:
    """Write a batch-1 per-row state into slot ``idx`` of the stacked
    state, in place; returns the stacked state."""
    def put(s, x):
        s.narrow(axis, int(idx), 1).copy_(x)
        return s
    return _map(put, stacked, row)


def clone_state(stacked: Any) -> Any:
    """A copy of the whole stacked state."""
    return _map(torch.clone, stacked)


def read_slot(stacked: Any, idx: int, axis: int = SLOT_AXIS) -> Any:
    """Slot ``idx`` as a batch-1 per-row state (a copy)."""
    return _map(lambda s: s.narrow(axis, int(idx), 1).clone(), stacked)
