"""Closed loop: ``clients`` clients, each sending its next request when
its last one completes.

The i-th of ``clients`` streams of sizes has its j-th request's output
and prompt lengths at the quantiles frac(o_i + j * golden) and frac(p_i +
j * silver) (``draws.Sequence``), the offsets spread evenly over [0, 1),
so every stream, and every stretch of it, covers the distributions
evenly; each stream's first request has a remaining output length
(``draws.residual``), so the window starts near steady state. The
streams are the same for every seed: the seed deals them to the clients
in an order of its own and draws every prompt's tokens (and the run's
weights). So a seed changes the inputs and who sends what, and not how
much work a window holds. At most ``per_client`` requests a client."""
from __future__ import annotations

import numpy as np

from harness import draws


class Traffic:
    def __init__(self, params: dict, seed: int, vocab: int):
        self.p = params
        self.seed, self.vocab = int(seed), int(vocab)
        c = self.clients = int(params["clients"])
        # the streams' starts: constants, the same for every seed
        s_out, s_in, s_first, s_left = draws.rng(0, 0).random(4)
        spread = np.arange(c) / c
        self.stream = draws.rng(seed, 0).permutation(c)   # client -> i
        self.outputs = [draws.Sequence(params["output"], s_out + x)
                        for x in spread]
        self.prompts = [draws.Sequence(params["prompt"], s_in + x,
                                       draws.SILVER) for x in spread]
        self.first_out = draws.residual(
            params["output"], (s_first + spread) % 1.0,
            (s_left + np.arange(c) * draws.GOLDEN) % 1.0)
        self.sent = [0] * c
        self.owner: dict[int, int] = {}      # rid -> client

    def sizes(self, client: int, j: int) -> tuple[int, int]:
        """(prompt length, output length) of a client's j-th request."""
        i = self.stream[client]
        out = self.first_out[i] if j == 0 else self.outputs[i][j]
        return self.prompts[i][j], int(out)

    def _send(self, sched, ledger, client: int, now: float):
        j = self.sent[client]
        if j >= int(self.p["per_client"]):
            raise RuntimeError(f"client {client} sent {j} requests; raise "
                               "'per_client'")
        self.sent[client] += 1
        n_in, n_out = self.sizes(client, j)
        index = client * int(self.p["per_client"]) + j
        req = sched.submit(draws.prompt(self.seed, index, n_in, self.vocab),
                           n_out)
        ledger.track(req, now)
        self.owner[req.rid] = client

    def start(self, sched, ledger, now: float):
        for c in range(self.clients):
            self._send(sched, ledger, c, now)

    def pump(self, sched, ledger, now: float, finished: list):
        for req in finished:
            self._send(sched, ledger, self.owner.pop(req.rid), now)
