"""Whether what the timed path served is right.

Once the window has closed, a sample drawn from the seed of the requests
the run finished (then, where they hold too few tokens, of those still
in flight), the longest among them first, is taken until it holds
``tokens`` served tokens. The plain reference runs
once over each prompt with its served tokens; at each served position
the gap by which the served token's logit lies below the reference's
best is read, and the widest gap over the sample is compared with the
cell's limit where the cell names it; so is the share of served tokens that are not the
reference's first. Greedy tokens only: every request of these mixes is
greedy.

The control is the reference itself in the precision just below the
configuration's (TF32 for float32 with TF32 off), read at the same
positions: the gap of the token that it puts first. ``as_program`` puts
its readings in the program's place, and ``judge`` holds them to the
same limits, so the control has to come out as not correct.
"""
from __future__ import annotations

import numpy as np
import torch

from harness import draws


def sample(done: list, live: list, seed: int, tokens: int,
           max_requests: int) -> list:
    """[(prompt, served tokens)] of finished requests: the longest, then
    others in an order drawn from the seed, until ``tokens`` served tokens or ``max_requests``; where
    the finished ones hold too few tokens, requests still in flight
    follow with the tokens they were served."""
    reqs = [r for _, r in done]
    reqs += [r for r in sorted(live, key=lambda r: r.rid)
             if len(r.tokens) >= 2]
    if not reqs:
        return []
    finished = reqs[:len(done)] or reqs
    longest = max(finished,
                  key=lambda r: (r.prompt.size + len(r.tokens), r.rid))
    picked = [longest]
    n_done = len(done)
    gen = draws.rng(seed, 3)
    order = np.concatenate([gen.permutation(n_done),
                            n_done + gen.permutation(len(reqs) - n_done)])
    for i in order:
        if sum(len(r.tokens) for r in picked) >= tokens \
                or len(picked) >= max_requests:
            break
        if all(reqs[i] is not r for r in picked):
            picked.append(reqs[i])
    return [(np.asarray(r.prompt, np.int64), list(r.tokens)) for r in picked]


def _logits(reference, cfg, params, prompt, served, device):
    seq = torch.as_tensor(np.concatenate([prompt, served[:-1]]),
                          dtype=torch.long, device=device)
    return reference.forward(cfg, params, seq)[prompt.size - 1:]


def _gaps(exact, picked):
    """Per position, how far below the reference's best logit the picked
    token's lies."""
    return exact.max(-1).values - exact.gather(1, picked[:, None])[:, 0]


def readings(reference, cfg, params, requests, device,
             control: bool = False) -> dict:
    """Over the sampled requests: ``token_gap``, the widest gap of a
    served token below the reference's best; ``mismatch_share``, the
    share of served tokens that are not the reference's first; ``tokens``
    read; ``by_request``, [served tokens, mismatches] of each request.
    With ``control``, the same two of the token that the reference
    computed with TF32 on puts first (``control_gap``,
    ``control_mismatch_share``)."""
    out = {"token_gap": 0.0, "mismatches": 0, "tokens": 0, "by_request": []}
    if control:
        out.update(control_gap=0.0, control_mismatches=0)
    for prompt, served in requests:
        exact = _logits(reference, cfg, params, prompt, served, device)
        gaps = _gaps(exact, torch.as_tensor(served, device=device))
        out["token_gap"] = max(out["token_gap"], gaps.max().item())
        out["mismatches"] += int((gaps > 0).sum())
        out["tokens"] += len(served)
        out["by_request"].append([len(served), int((gaps > 0).sum())])
        if control:
            prev = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                low = _logits(reference, cfg, params, prompt, served,
                              device)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = prev
            gaps = _gaps(exact, low.argmax(-1))
            out["control_gap"] = max(out["control_gap"], gaps.max().item())
            out["control_mismatches"] += int((gaps > 0).sum())
    n = max(out["tokens"], 1)
    out["mismatch_share"] = out["mismatches"] / n
    if control:
        out["control_mismatch_share"] = out["control_mismatches"] / n
    return out


def judge(spec: dict, readings: dict) -> dict:
    """Each number the cell compares, with its limit: the cell's
    ``limits`` (at most) and the tokens read (at least)."""
    checks = {name: {"value": readings[name], "limit": limit}
              for name, limit in spec["limits"].items()}
    checks["tokens_checked"] = {"value": readings["tokens"],
                                "limit": spec["tokens"], "at_least": True}
    return checks


def passes(checks: dict) -> bool:
    return all((c["value"] >= c["limit"]) if c.get("at_least")
               else (c["value"] <= c["limit"]) for c in checks.values())


def as_program(readings: dict) -> dict:
    """The control's readings under the program's names."""
    return dict(readings, token_gap=readings["control_gap"],
                mismatch_share=readings["control_mismatch_share"])
