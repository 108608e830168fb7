"""Stack and unstack decode-slot states into one slot-batched state.

Two layouts cover the ported families:

  * dense, MoE, hybrid and enc-dec: every decode-state leaf is laid out
    [L(layers), B(slots), ...], so the batch axis IS the slot axis
    (``SLOT_AXIS == 1``). With the per-row cache each row carries its own
    KV length and positions, so rows decode at independent positions in
    one round. An MoE decoder's state is the KV cache alone (routing
    keeps no state between rounds). A hybrid's state also carries the mamba branch's conv
    window [L, B, K-1, di] and SSM state [L, B, di, n] (``{"kv": ...,
    "mamba": {"conv", "ssm"}}``), overwritten by every round as the cache
    is appended to.
    Enc-dec states also carry the per-slot cross-attention bank (the
    encoder-derived K/V [L, B, Se, Hkv, hd] and positions [L, B, Se]),
    written row-wise at admission: the encoder runs once per request, and
    the bank holds decoded (r-independent) values, so a re-encode or
    ``set_code_r`` keeps it valid; the 2MR requeue path re-admits the
    request and so runs its encoder again.
  * xLSTM: the state is a list of per-block recurrent states whose leaves
    lead with the batch axis (slot axis 0, ``slot_axis``); a round
    overwrites every row's state instead of appending by position.

Admission overwrites one row in place, so the stacked state keeps its
addresses (a captured round stays valid across admissions).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

SLOT_AXIS = 1


def slot_axis(model) -> int:
    """Which leaf axis indexes slots for this family: 0 for xLSTM (block
    state has no leading layer axis), 1 ([L, B, ...]) for everything
    else."""
    return 0 if model.cfg.ssm_kind == "xlstm" else SLOT_AXIS


def supports_slot_batching(model) -> bool:
    """Every ported family slot-batches: decoders (dense, MoE, hybrid) via
    per-row KV positions, enc-dec via the per-slot cross-attention bank,
    xLSTM via its positionless [B, ...] block state. Kept as the API point
    of the scheduler's auto mode (``RuntimeConfig.batched=None``)."""
    return True


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_map(fn, *sub) for sub in zip(*trees)]
    return fn(*trees)


def request_batch(prompt, extras: dict | None = None) -> dict:
    """One request's prefill batch: [1, S] int32 tokens plus its extras
    (enc-dec ``frames``) with a leading batch axis of 1. Both executors
    build their prefill batches here."""
    batch = {"tokens": np.asarray(prompt, np.int32)[None, :]}
    for key, val in (extras or {}).items():
        batch[key] = np.asarray(val)[None, ...]
    return batch


def blank_state(stepper, n_slots: int) -> Any:
    """A zero-filled stacked per-row state with ``n_slots`` rows, allocated
    from the state's layout without running the model (for an enc-dec, no
    encoder over zero frames). Admission overwrites a row wholesale before
    it is read; never-admitted rows step through decode harmlessly (as in
    the reference, whose blank state is zeros of the same shapes: an
    xLSTM row's stabilizer m is 0 here, not -1e30)."""
    state = stepper.model.empty_decode(n_slots, stepper.max_len,
                                       stepper.cache_dtype, stepper.device)
    return _map(torch.zeros_like, state)


def stack_states(states: list[Any], axis: int = SLOT_AXIS) -> Any:
    """Concatenate batch-1 per-row states along the slot axis."""
    return _map(lambda *xs: torch.cat(xs, dim=axis), *states)


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


def unstack_states(stacked: Any, n_slots: int, axis: int = SLOT_AXIS
                   ) -> list[Any]:
    """Every slot as a batch-1 per-row state (copies)."""
    return [read_slot(stacked, i, axis=axis) for i in range(n_slots)]
