"""Request objects flowing through the coded cluster runtime.

A request is a prompt plus a token budget. The scheduler owns all state
transitions; the paper's operational claim — "the system never loses a
request" — means every submitted request terminates in COMPLETED, possibly
after one or more requeues through the 2MR fallback path (§6.3).
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    COMPLETED = "completed"
    SHED = "shed"                       # dropped by the queue-depth bound


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [prompt_len] int32 token ids
    max_new_tokens: int
    arrival_ms: float = 0.0
    deadline_ms: float | None = None    # SLO deadline (None = best effort)
    priority: int = 0                   # higher pops first
    extras: dict | None = None          # extra per-request batch fields,
    #                                     unbatched (enc-dec "frames"
    #                                     [enc_seq, D]); admission adds the
    #                                     leading batch axis

    # -- mutated by the scheduler ------------------------------------------
    state: RequestState = RequestState.QUEUED
    tokens: list[int] = dataclasses.field(default_factory=list)
    slot: int | None = None
    admitted_ms: float | None = None
    first_token_ms: float | None = None
    finished_ms: float | None = None
    n_requeues: int = 0
    shed_reason: str | None = None      # stamped by the admission queue:
    #                                     "queue_full" (arrived into a full
    #                                     queue, sorted last) | "displaced"
    #                                     (a better-ordered arrival pushed
    #                                     it out)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.ndim != 1 or self.prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens

    @property
    def latency_ms(self) -> float | None:
        """Submit-to-last-token latency (includes queueing + requeues)."""
        if self.finished_ms is None:
            return None
        return self.finished_ms - self.arrival_ms

    @property
    def queueing_ms(self) -> float | None:
        """Time spent queued before the (final) admission."""
        if self.admitted_ms is None:
            return None
        return self.admitted_ms - self.arrival_ms

    @property
    def ttft_ms(self) -> float | None:
        """Time to first token: arrival -> first token of the SURVIVING
        run (a 2MR requeue discards partial progress, so the stamp resets
        with it — TTFT then includes the full requeue delay, which is
        what an SLO sees)."""
        if self.first_token_ms is None:
            return None
        return self.first_token_ms - self.arrival_ms

    def reset_for_requeue(self):
        """Discard partial progress; the request goes back to the queue.

        CDC recovery never takes this path — it is the 2MR half of the
        hybrid policy, for failures beyond the code's erasure budget.

        ``first_token_ms`` resets with the progress (TTFT then includes
        the full requeue delay); span state resets with it — the
        scheduler's ``SpanTracker.on_requeue`` closes the discarded
        decode episode and opens a ``fault_recovery`` span at the same
        instant, so the span tree and the stamps never disagree.
        """
        self.state = RequestState.QUEUED
        self.tokens = []
        self.slot = None
        self.admitted_ms = None
        self.first_token_ms = None
        self.n_requeues += 1
