"""One vectorised decode round over the stacked slot state.

The whole slot pool advances one token per round. Two variants:

  * reference — the model's coded decode returning full last-position
    logits, then argmax;
  * fused — the model body runs with ``ctx.fused_body=True``, so every
    in-body coded GEMM (attention QKV, FFN up/gate) goes through the fused
    coded-GEMM kernel, and the final norm feeds the fused coded-head
    kernel (head GEMM + parity decode + argmax; no logits in memory).
    Valid for <= 1 dead shard: ``round`` counts the host mask BEFORE
    dispatch and sends a 2+-erasure round to the reference variant.

``use_fused="auto"`` takes the fused variant when the params live on a
CUDA device; on the CPU the same variant runs the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.cdc_decode import head_parity


def _fused_supported(stepper) -> bool:
    # the fused head consumes the all-ones sum-parity generator row
    return (stepper.coded
            and bool(np.allclose(stepper.model.ctx.spec.code.generator[0],
                                 1.0)))


class VStep:
    """Owns the two round variants and the dispatch counter."""

    def __init__(self, stepper, use_fused: bool | str = "auto"):
        self.stepper = stepper
        if use_fused == "auto":
            use_fused = stepper.device.type == "cuda"
        self.use_fused = bool(use_fused) and _fused_supported(stepper)
        self.n_dispatches = 0
        self.last_variant = "reference"
        self._head_cache: tuple[int, Any, Any] | None = None

    def _head_shards(self):
        """[T, k, m_l] column shards of the LM head (a view of lm_head.w,
        no copy) and the sum-parity weight [k, m_l], computed once per
        params object (refreshed by re-encode)."""
        params = self.stepper.params
        if self._head_cache is None or self._head_cache[0] != id(params):
            w = params["lm_head"]["w"]
            k, m = w.shape
            t = self.stepper.n_shards
            w_shards = w.view(k, t, m // t).permute(1, 0, 2)
            self._head_cache = (id(params), w_shards,
                                head_parity(w_shards))
        return self._head_cache[1], self._head_cache[2]

    def _round(self, state, toks, valid):
        logits, new_state = self.stepper.model.decode(
            self.stepper.params, state, toks, valid)
        last = logits[:, -1:]
        return new_state, torch.argmax(last, dim=-1).to(torch.int32), last

    def _round_fused(self, state, toks, valid):
        model = self.stepper.model
        fm = dataclasses.replace(
            model, ctx=dataclasses.replace(model.ctx, fused_body=True))
        hidden, new_state = fm.decode(self.stepper.params, state, toks,
                                      valid, return_hidden=True)
        w_shards, parity_w = self._head_shards()
        tok, _ = ops.fused_head_argmax(
            hidden[:, -1, :].to(torch.float32).contiguous(), w_shards,
            parity_w, valid, vocab=model.cfg.vocab)
        return new_state, tok[:, None]

    def round(self, state, toks, valid):
        """One decode round. valid: [T] host mask. Returns (new_state,
        next_toks [n, 1] int32, last_logits or None for the fused head)."""
        st = self.stepper
        v = st._mask(valid) if st.coded else None
        self.n_dispatches += 1
        if self.use_fused and v is not None \
                and int(st.n_shards - int(v.sum())) <= 1:
            self.last_variant = "fused"
            new_state, nxt = self._round_fused(state, toks, v)
            return new_state, nxt, None
        self.last_variant = "reference"
        return self._round(state, toks, v)
