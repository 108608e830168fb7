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

**One dispatch a round.** The reference package compiles each variant
once and dispatches a round as one program. The port's counterpart is a
CUDA graph: with ``use_graphs`` (default: on a CUDA device with the fused
variant) the fused round is captured once per key — the stepper's parity
``encode_generation`` and the host mask, so at most T + 1 graphs per
encode — and every fused round replays its key's graph. The graph's
static inputs are the stacked KV state (updated in place by the model)
and the caller's token buffer [n_slots, 1], into which the round writes
its argmax. Before a key is captured, one eager round runs on clones of
the state and tokens (the warm-up: kernel builds, first-launch attributes,
decode plans and the head parity happen outside the capture). A new
encode generation (re-encode after a heal or swap, ``set_code_r``) drops
every graph and the head cache: the kernels' tensor maps bake the weight
and parity addresses into the graph. A capture that fails raises. The
eager fused round stays as the test oracle (``use_graphs=False``).

Counters: ``n_dispatches`` (every round), ``n_fused_rounds``,
``n_captures``, ``n_replays`` (the port's form of the reference's
``n_traces``: with graphs, one replay per fused round) and
``n_graph_drops`` (encode generations that found graphs to drop). A replay
runs no Python, so each wrapper's launch count is credited with what the
capture recorded (``kernels.accounting``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.kernels import accounting, ops
from repro_torch.kernels.cdc_decode import head_parity
from repro_torch.runtime.executor.slotbatch import clone_state


def _fused_supported(stepper) -> bool:
    # the fused head consumes the all-ones sum-parity generator row
    return (stepper.coded
            and bool(np.allclose(stepper.model.ctx.spec.code.generator[0],
                                 1.0)))


class RoundGraph:
    """One captured fused round on a CUDA device (``torch.cuda.CUDAGraph``),
    its launch counts as the capture recorded them, and the outputs the
    capture allocated (kept alive: a replay writes them again)."""

    @staticmethod
    def new_pool():
        """A memory pool for the graphs of one encode generation."""
        return torch.cuda.graph_pool_handle()

    def __init__(self, pool):
        self.pool = pool
        self.graph = torch.cuda.CUDAGraph()
        self.launches: dict = {}
        self.outputs: Any = None

    def capture(self, fn, *args):
        """Record ``fn(*args)`` (nothing runs: a capture only records)."""
        with torch.cuda.graph(self.graph, pool=self.pool):
            self.outputs = fn(*args)

    def replay(self):
        self.graph.replay()


# the graph class VStep captures with (the CPU tests substitute a recorder)
GRAPH = RoundGraph


class VStep:
    """Owns the two round variants, the captured graphs and the counters."""

    def __init__(self, stepper, use_fused: bool | str = "auto",
                 use_graphs: bool | str = "auto"):
        self.stepper = stepper
        if use_fused == "auto":
            use_fused = stepper.device.type == "cuda"
        self.use_fused = bool(use_fused) and _fused_supported(stepper)
        if use_graphs == "auto":
            use_graphs = stepper.device.type == "cuda"
        self.use_graphs = bool(use_graphs) and self.use_fused
        self.n_dispatches = 0
        self.n_fused_rounds = 0
        self.n_captures = 0
        self.n_replays = 0
        self.n_graph_drops = 0
        self.last_variant = "reference"
        # kernel 2's (token, max logit) of the last fused round
        self.last_head: tuple[torch.Tensor, torch.Tensor] | None = None
        self._generation: int | None = None
        self._head_cache: tuple[Any, Any] | None = None
        self._graphs: dict[tuple, Any] = {}
        self._pool = None

    def _sync_generation(self):
        """Drop the graphs, their memory pool and the head cache when the
        parity was re-encoded since they were made. A pool whose graphs
        are all gone cannot take a new capture, so the next generation's
        graphs get a pool of their own."""
        gen = self.stepper.encode_generation
        if gen != self._generation:
            if self._graphs:
                self.n_graph_drops += 1
            self._graphs.clear()
            self._pool = None
            self._head_cache = None
            self._generation = gen

    def _head_shards(self):
        """[T, k, m_l] column shards of the LM head (a view of lm_head.w,
        no copy) and the sum-parity weight [k, m_l], computed once per
        encode generation."""
        self._sync_generation()
        if self._head_cache is None:
            w = self.stepper.params["lm_head"]["w"]
            k, m = w.shape
            t = self.stepper.n_shards
            w_shards = w.view(k, t, m // t).permute(1, 0, 2)
            self._head_cache = (w_shards, head_parity(w_shards))
        return self._head_cache

    def _round(self, state, toks, valid):
        logits, new_state = self.stepper.model.decode(
            self.stepper.params, state, toks, valid)
        last = logits[:, -1:]
        return new_state, torch.argmax(last, dim=-1).to(torch.int32), last

    def _round_fused(self, state, toks, valid):
        """The fused round; writes the next tokens into ``toks`` (the
        graph's static token buffer) and returns kernel 2's (token, max)."""
        model = self.stepper.model
        fm = dataclasses.replace(
            model, ctx=dataclasses.replace(model.ctx, fused_body=True))
        hidden, _ = fm.decode(self.stepper.params, state, toks, valid,
                              return_hidden=True)
        w_shards, parity_w = self._head_shards()
        tok, vmax = ops.fused_head_argmax(
            hidden[:, -1, :].to(torch.float32).contiguous(), w_shards,
            parity_w, valid, vocab=model.cfg.vocab)
        toks.copy_(tok[:, None])
        return tok, vmax

    def _graph(self, state, toks, valid):
        """The captured round of the current (encode generation, mask),
        captured on first use after an eager warm-up on clones."""
        self._sync_generation()
        key = (self._generation, tuple(bool(b) for b in valid.tolist()))
        g = self._graphs.get(key)
        if g is not None:
            return g
        with accounting.uncounted():
            self._round_fused(clone_state(state), toks.clone(), valid)
        if self._pool is None:
            self._pool = GRAPH.new_pool()
        g = GRAPH(self._pool)
        before = accounting.snapshot()
        try:
            g.capture(self._round_fused, state, toks, valid)
            g.launches = accounting.since(before)
        finally:
            accounting.restore(before)   # a capture launches nothing
        self._graphs[key] = g
        self.n_captures += 1
        return g

    def round(self, state, toks, valid):
        """One decode round. valid: [T] host mask. Returns (new_state,
        next_toks [n, 1] int32, last_logits or None for the fused head);
        a fused round writes next_toks into ``toks`` and returns it."""
        st = self.stepper
        v = st._mask(valid) if st.coded else None
        self.n_dispatches += 1
        if self.use_fused and v is not None \
                and int(st.n_shards - int(v.sum())) <= 1:
            self.last_variant = "fused"
            self.n_fused_rounds += 1
            if self.use_graphs:
                g = self._graph(state, toks, v)
                g.replay()
                accounting.credit(g.launches)
                self.n_replays += 1
                self.last_head = g.outputs
            else:
                self.last_head = self._round_fused(state, toks, v)
            return state, toks, None
        self.last_variant = "reference"
        return self._round(state, toks, v)
