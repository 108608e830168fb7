"""Priority / SLO-aware admission queue for the coded cluster runtime.

Admission order is by (priority desc, deadline asc, arrival asc, rid):
with no deadlines or priorities set this degenerates to exact FIFO, and a
request requeued by the 2MR fallback (which keeps its original arrival
time) naturally re-enters ahead of later arrivals — the same ordering the
old deque gave, now as one total order that deadlines and priorities can
bend.

Shedding: with a ``max_depth`` bound, pushing into a full queue drops the
WORST-ordered sheddable request (the incoming one, if it sorts last)
instead of growing without bound — deadline-aware tail drop. Requests
that were ever admitted (``n_requeues > 0``: the 2MR fallback put them
back) are NEVER shed — neither at their own force-push nor as the victim
of a later push — preserving the paper's "never loses a request" claim
for admitted work; the queue may exceed the bound by the number of such
protected requests.
"""
from __future__ import annotations

import bisect

from repro_torch.runtime.request import Request


def _key(req: Request):
    deadline = req.deadline_ms if req.deadline_ms is not None else float("inf")
    return (-req.priority, deadline, req.arrival_ms, req.rid)


def _protected(req: Request) -> bool:
    return req.n_requeues > 0


class AdmissionQueue:
    def __init__(self, max_depth: int | None = None, spans=None, clock=None):
        if max_depth is not None and max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        # span emission point: shedding is the queue's decision, so the
        # queue stamps the reason and terminates the victim's span tree
        # (obs.spans.SpanTracker | None; clock supplies the sim stamp)
        self.spans = spans
        self.clock = clock
        self._q: list[tuple[tuple, Request]] = []    # sorted by key

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def __iter__(self):
        return (req for _, req in self._q)

    def push(self, req: Request, force: bool = False) -> Request | None:
        """Insert ``req``; returns the request shed by the depth bound (the
        worst-ordered sheddable one — possibly ``req`` itself), or None."""
        bisect.insort(self._q, (_key(req), req))
        if force or self.max_depth is None or len(self._q) <= self.max_depth:
            return None
        for i in range(len(self._q) - 1, -1, -1):
            if not _protected(self._q[i][1]):
                victim = self._q.pop(i)[1]
                victim.shed_reason = "queue_full" if victim is req \
                    else "displaced"
                if self.spans is not None:
                    t = self.clock.now() if self.clock is not None \
                        else victim.arrival_ms
                    self.spans.on_shed(victim, t, victim.shed_reason)
                return victim
        return None    # every entry is in-flight work put back by 2MR

    def pop(self) -> Request:
        """Earliest-deadline (then FIFO) request."""
        return self._q.pop(0)[1]

    def peek(self) -> Request:
        return self._q[0][1]
