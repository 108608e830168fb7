"""Serving stepper and the one-batch serving facade.

  * ``ModelStepper`` owns the CDC-encoded params and exposes prefill /
    decode-one-token / re-encode. The runtime feeds it the CURRENT host
    validity mask on each call, so a shard lost mid-request is recovered
    inside the same step (paper §5.2).
  * ``ServingEngine`` is the one-batch-at-a-time facade; ``generate`` runs
    through the batched ``SlotPoolExecutor`` (the serving hot path), and
    ``_generate_sequential`` stays as the differential-test oracle.

A prefill runs the model's unfused body (cuBLAS products for x @ w and
the parity). On a CUDA device, with a code that has the all-ones sum row
and at most one dead shard, each coded GEMM's decode and merge then runs
as the decode-and-merge kernel (``ctx.fused_decode``: one launch from a
cached plan, so the forward makes no host-device synchronisation); 2+
dead shards, the CPU and a code without the sum row take the reference
decode. The fused coded-GEMM and head kernels serve decode rounds only.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.failure import StragglerModel, request_latency
from repro_torch.models.mamba2 import prefill_chunks
from repro_torch.models.zoo import Model
from repro_torch.obs.tracer import NULL_RECORDER


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 2048
    batch: int = 8
    cache_dtype: Any = torch.float32


class ModelStepper:
    """Thin model stepper the runtime drives. Slot states are caller-owned
    trees of tensors (the per-row KV cache layout, with a hybrid's mamba
    state beside it, or xLSTM's list of block states)."""

    def __init__(self, model: Model, params, max_len: int,
                 cache_dtype: Any = torch.float32, tracer=None):
        self.model = model
        # the decode the last prefill's coded GEMMs took where the choice
        # is on: "fused" or "reference" (else None)
        self.last_prefill_decode: str | None = None
        self.max_len = int(max_len)
        self.cache_dtype = cache_dtype
        # flight recorder; the scheduler re-binds its own so code-geometry
        # changes land in the same event stream
        self.tracer = tracer if tracer is not None else NULL_RECORDER
        self._raw_params = params
        self.params = model.encode_offline(params)
        self.coded = bool(model.ctx.coded)
        self.n_shards = max(int(model.ctx.tp), 1)
        spec = model.ctx.spec
        self.erasure_budget = int(spec.max_device_failures) if spec else 0
        # wall time of the last parity re-encode (on a CUDA device measured
        # to the end of its kernels)
        self.last_reencode_wall_ms: float = 0.0
        # the CUDA event pair around the last prefill (a timing recorder
        # on a card; else None), read by its admitter once the first
        # token is on the host
        self.last_prefill_events: tuple | None = None
        # whether the model has Mamba-2 layers; the last prefill's CUDA
        # event pair around each of its Mamba-2 mixers (a timing recorder
        # on a card; else None), and the SSD chunks they took
        self.has_mamba2 = prefill_chunks(model.cfg, 1) > 0
        self.last_prefill_mamba: list | None = None
        self.last_prefill_chunks: int = 0
        # bumped by every parity encode after the first: what a round
        # captured against the old parity (a CUDA graph, the head cache)
        # keys on
        self.encode_generation: int = 0

    @property
    def device(self) -> torch.device:
        return self._raw_params["embed"].device

    @property
    def sum_row(self) -> bool:
        """The code has the all-ones sum-parity generator row (what the
        fused kernels decode with)."""
        gen = self.model.ctx.spec.code.generator if self.coded else None
        return gen is not None and len(gen) > 0 \
            and bool(np.allclose(gen[0], 1.0))

    @property
    def fused_prefill_on(self) -> bool:
        """A coded model whose prefill may decode through the kernel: its
        params live on a CUDA device, or its ctx already asks for the
        kernel (on the CPU its plain version runs)."""
        return self.coded and (self.device.type == "cuda"
                               or self.model.ctx.fused_decode)

    def _prefill_model(self, v) -> Model:
        """The model a prefill under the host mask ``v`` runs, and
        ``last_prefill_decode`` set to the decode its coded GEMMs take
        (None where the choice is off, or with no mask: no decode)."""
        if v is None or not self.fused_prefill_on:
            self.last_prefill_decode = None
            return self.model
        fused = self.sum_row and int(v.numel() - int(v.sum())) <= 1
        self.last_prefill_decode = "fused" if fused else "reference"
        if fused == self.model.ctx.fused_decode:
            return self.model
        ctx = dataclasses.replace(self.model.ctx, fused_decode=fused)
        return dataclasses.replace(self.model, ctx=ctx)

    # ------------------------------------------------------------ coding ----
    def _encode(self):
        """Drop the current parity leaves, then encode new ones from the
        raw params, recording the wall time. Dropping first keeps one
        parity set alive instead of two (at full width ~10 GiB at r=2,
        ~20 GiB at r=4 folded). The caller guarantees that no host code
        still reads the old leaves; device rounds already queued on the
        stream keep their memory until they have run (the caching
        allocator hands freed blocks only to work queued after them)."""
        self.params = None
        sync = self.device.type == "cuda"
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.params = self.model.encode_offline(self._raw_params)
        if sync:
            torch.cuda.synchronize()
        self.last_reencode_wall_ms = (time.perf_counter() - t0) * 1e3
        self.encode_generation += 1

    def reencode(self):
        """Offline parity re-encode (paper §5.1), after a heal or swap."""
        with self.tracer.span("host.reencode"):
            self._encode()

    def set_code_r(self, code_r: int) -> bool:
        """Re-size the parity budget and re-encode; returns True iff the
        code geometry changed. Decode states are r-independent."""
        code_r = int(code_r)
        if code_r < 0:
            raise ValueError(f"code_r must be >= 0, got {code_r}")
        if not self.coded or code_r == int(self.model.ctx.code_r):
            return False
        r_old = int(self.model.ctx.code_r)
        ctx = dataclasses.replace(self.model.ctx, code_r=code_r)
        self.model = dataclasses.replace(self.model, ctx=ctx)
        self._encode()
        spec = ctx.spec
        self.erasure_budget = int(spec.max_device_failures) if spec else 0
        if self.tracer.enabled:
            self.tracer.emit("code.resize", track="rounds", r_old=r_old,
                             r_new=code_r, budget=self.erasure_budget)
        return True

    def full_mask(self) -> np.ndarray:
        return np.ones(self.n_shards, bool)

    def _mask(self, valid) -> torch.Tensor | None:
        """The host (CPU) bool mask the model layers consume."""
        if valid is None:
            return None
        return torch.as_tensor(np.asarray(valid, bool))

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.device)

    # ---------------------------------------------------------- stepping ----
    def prefill(self, batch: dict, valid=None) -> tuple[torch.Tensor, Any]:
        """Run the prompt through the decode path into a fresh per-row
        state (an enc-dec's encoder runs over ``batch["frames"]`` under the
        same mask first). Returns (last-position logits [b, 1, V],
        state). A timing recorder spans the state's making and the
        forward's enqueue, and on a card times the whole on the device
        (``last_prefill_events``) and the forward's Mamba-2 mixers
        (``last_prefill_mamba``)."""
        tr = self.tracer
        with tr.span("host.prefill"):
            events = tr.device_events()
            v = self._mask(valid) if self.coded else None
            model = self._prefill_model(v)
            tokens = self._tokens(batch["tokens"])
            with tr.span("host.prefill.state"):
                state = model.init_decode(
                    self.params, batch, tokens.shape[0], self.max_len,
                    self.cache_dtype, valid=v)
            with tr.span("host.prefill.forward"), \
                    tr.mamba_pairs() as pairs:
                logits, state = model.decode(self.params, state, tokens, v)
            self.last_prefill_mamba = pairs
            self.last_prefill_chunks = prefill_chunks(model.cfg,
                                                      tokens.shape[1])
            if events is not None:
                events[1].record()
            self.last_prefill_events = events
        return logits[:, -1:], state

    def decode_one(self, state, tok, valid=None) -> tuple[torch.Tensor, Any]:
        """One decode step: tok [b, 1] -> (logits [b, 1, V], state)."""
        v = self._mask(valid) if self.coded else None
        if not isinstance(tok, torch.Tensor):
            tok = self._tokens(tok)
        return self.model.decode(self.params, state, tok, v)

    @staticmethod
    def greedy(logits: torch.Tensor) -> torch.Tensor:
        # first maximal index on ties, as jnp.argmax
        return torch.argmax(logits, dim=-1).to(torch.int32)

    # ------------------------------------------------- straggler model ----
    def straggler_latency(self, straggler: StragglerModel,
                          n_trials: int = 10000, seed: int = 0) -> dict:
        """First-T-of-(T+r) request latency (paper Fig. 14/15)."""
        T = self.n_shards
        r = int(self.model.ctx.code_r if self.coded else 0)
        rng = np.random.default_rng(seed)
        times = straggler.sample(rng, (n_trials, T + r))
        coded = request_latency(times, T)
        uncoded = request_latency(times[:, :T], T)
        return {
            "mean_coded_ms": float(coded.mean()),
            "mean_uncoded_ms": float(uncoded.mean()),
            "p99_coded_ms": float(np.percentile(coded, 99)),
            "p99_uncoded_ms": float(np.percentile(uncoded, 99)),
        }


class ServingEngine:
    """One batch at a time, caller-managed failure injection. ``generate``
    runs through the batched ``SlotPoolExecutor`` (every batch row is a
    slot); ``use_fused`` selects its round variant ("auto": the fused
    kernels when the params live on a CUDA device) and ``use_graphs``
    whether fused rounds replay captured CUDA graphs ("auto": on a CUDA
    device); both may be changed between calls."""

    def __init__(self, model: Model, params, scfg: ServeConfig,
                 use_fused: bool | str = "auto",
                 use_graphs: bool | str = "auto"):
        self.model = model
        self.scfg = scfg
        self.use_fused = use_fused
        self.use_graphs = use_graphs
        self.stepper = ModelStepper(model, params, scfg.max_len,
                                    scfg.cache_dtype)
        self.valid = np.ones(self.stepper.n_shards, bool)
        self.metrics = {"requests": 0, "erasures_recovered": 0,
                        "requeued": 0}
        # (batch size, use_fused, use_graphs) -> executor
        self._executors: dict[tuple, Any] = {}

    @property
    def params(self):
        return self.stepper.params

    # -------------------------------------------------------- failures ----
    def inject_failure(self, shard: int):
        """Mark a TP shard dead. Subsequent steps recover via parity."""
        self.valid = self.valid.copy()
        self.valid[shard] = False
        self.metrics["erasures_recovered"] += 1

    def heal(self, shard: int | None = None):
        self.valid = self.valid.copy()
        if shard is None:
            self.valid[:] = True
        else:
            self.valid[shard] = True
        self.stepper.reencode()

    # ---------------------------------------------------------- serving ----
    def prefill(self, batch: dict):
        return self.stepper.prefill(batch, self.valid)

    def executor(self, b: int):
        """The executor ``generate`` runs a batch of ``b`` through under
        the current ``use_fused`` and ``use_graphs``."""
        from repro_torch.runtime.executor import SlotPoolExecutor
        key = (b, self.use_fused, self.use_graphs)
        ex = self._executors.get(key)
        if ex is None:
            ex = self._executors[key] = SlotPoolExecutor(
                self.stepper, n_slots=b, overlap=False,
                use_fused=self.use_fused, use_graphs=self.use_graphs)
        return ex

    def generate(self, batch: dict, n_tokens: int,
                 fail_at: dict[int, int] | None = None) -> np.ndarray:
        """Greedy generation; ``fail_at`` maps step -> shard to kill
        mid-request (the paper's Case Study II). Every batch field but the
        tokens (enc-dec ``frames``) is split per row and admitted with its
        row."""
        tokens = np.asarray(batch["tokens"])
        extras_all = {k: np.asarray(v) for k, v in batch.items()
                      if k != "tokens"}
        b = tokens.shape[0]
        ex = self.executor(b)
        ex.drop_pending()
        ex.evict_all()
        out = np.zeros((b, n_tokens), np.int64)
        for i in range(b):
            extras = {k: v[i] for k, v in extras_all.items()} or None
            out[i, 0] = ex.admit(i, tokens[i], self.valid, tag=i,
                                 extras=extras)
        for t in range(n_tokens - 1):
            if fail_at and t in fail_at:
                self.inject_failure(fail_at[t])
            for slot, _, tok in ex.step_round(self.valid):
                out[slot, t + 1] = tok
        self.metrics["requests"] += b
        return out

    def _generate_sequential(self, batch: dict, n_tokens: int,
                             fail_at: dict[int, int] | None) -> np.ndarray:
        """Sequential stepping of the whole batch — the oracle the batched
        path is pinned against."""
        logits, state = self.prefill(batch)
        tok = self.stepper.greedy(logits)
        out = [tok]
        for t in range(n_tokens - 1):
            if fail_at and t in fail_at:
                self.inject_failure(fail_at[t])
            logits, state = self.stepper.decode_one(state, tok, self.valid)
            tok = self.stepper.greedy(logits)
            out.append(tok)
        self.metrics["requests"] += batch["tokens"].shape[0]
        return np.concatenate([t.cpu().numpy() for t in out], axis=1)

    def straggler_latency(self, straggler: StragglerModel,
                          n_trials: int = 10000, seed: int = 0) -> dict:
        return self.stepper.straggler_latency(straggler, n_trials, seed)
