"""Readings shared by the metric modules (each metric is a file of its
own under bench/metrics/)."""
from __future__ import annotations

from harness import costs, probes, stats


def window_s(run) -> float:
    w0, w1 = run.window
    return (w1 - w0) / 1e3


def round_ms_mean(run):
    ms = probes.event_ms(run, "round")
    return sum(ms) / len(ms) if ms else None


def prefill_ms_median(run):
    return stats.median(probes.event_ms(run, "prefill"))


def install_round(run):
    probes.timed(run, run.sched.executor.vstep, "round", "round")


def install_prefill(run):
    probes.timed(run, run.sched.stepper, "prefill", "prefill")


def window_flops(run) -> float:
    """Useful FLOPs of the tokens delivered in the window: a first token
    counts its prefill, any later token its decode over the real
    context; no parity, padding, or work redone after a requeue."""
    w0, w1 = run.window
    led, cfg = run.ledger, run.cfg
    total = 0.0
    for t, rid, pos in led.deliveries:
        if not w0 < t <= w1:
            continue
        p = led.prompt_len[rid]
        total += costs.prefill_flops(cfg, p) if pos == 0 \
            else costs.decode_flops(cfg, p + pos)
    return total


def roofline_pct(run, name: str):
    got = (run.ranges or {}).get(name)
    if not got or got["device_s"] <= 0:
        return None
    return 100.0 * got["least_s"] / got["device_s"]
