"""What a client sees: each request's tokens as they reach the host.

After every ``sched.step()`` the harness calls ``observe(now)``. A
request's output position counts once, the first time it reaches the
host; positions a request regenerates after a requeue (the scheduler
resets its tokens) are not delivered again. Every gap between two
successive deliveries of a request is kept, a stall across a requeue
or a prefill as it is.
"""
from __future__ import annotations

from repro_torch.runtime.request import RequestState


class Ledger:
    def __init__(self):
        self.live: dict[int, object] = {}       # rid -> Request
        self.due: dict[int, float] = {}         # rid -> due time (ms)
        self.high: dict[int, int] = {}          # rid -> positions delivered
        self.prompt_len: dict[int, int] = {}    # rid -> prompt tokens
        self.last: dict[int, float] = {}        # rid -> last delivery (ms)
        self.deliveries: list[tuple[float, int, int]] = []  # (t, rid, pos)
        self.gaps: list[tuple[float, float]] = []           # (t, gap ms)
        self.done: list[tuple[float, object]] = []          # (t, Request)

    def track(self, req, due_ms: float):
        self.live[req.rid] = req
        self.due[req.rid] = float(due_ms)
        self.high[req.rid] = 0
        self.prompt_len[req.rid] = int(req.prompt.size)

    def observe(self, now: float) -> list:
        """Record the tokens that reached the host by ``now``; returns
        the requests that completed since the last call."""
        finished = []
        for rid, req in list(self.live.items()):
            n, hi = len(req.tokens), self.high[rid]
            for pos in range(hi, n):
                self.deliveries.append((now, rid, pos))
                if pos:
                    self.gaps.append((now, now - self.last[rid]))
                self.last[rid] = now
            if n > hi:
                self.high[rid] = n
            if req.state is RequestState.COMPLETED:
                del self.live[rid]
                self.done.append((now, req))
                finished.append(req)
        return finished

    # ------------------------------------------------------- the window ----
    def tokens_in(self, t0: float, t1: float) -> int:
        return sum(1 for t, _, _ in self.deliveries if t0 <= t <= t1)

    def gaps_in(self, t0: float, t1: float) -> list[float]:
        return [g for t, g in self.gaps if t0 <= t <= t1]
