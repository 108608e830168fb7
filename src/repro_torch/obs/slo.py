"""SLO decomposition: TTFT/TPOT breakdowns and deadline-miss attribution
(the port's own copy of the reference package's host-only ``obs/slo.py``).

Consumes the span trees built by ``obs.spans`` and answers, per request:

* where did the time go? (``queue_wait / prefill / decode / stall /
  fault_recovery`` sums that tile the request's latency),
* what made the first token late? (TTFT decomposition: initial queue
  wait + prefill + every fault_recovery episode and the decode work it
  discarded),
* did it miss its deadline, and WHY? — every miss (and every shed) is
  attributed to exactly one dominant cause from ``CAUSES``.

Aggregates (``summarize``) yield p50/p99 TTFT/TPOT with per-phase
breakdown percentiles plus miss/shed-by-cause counts; these feed
``repro_slo_*`` Prometheus series and the CLI::

    python -m repro_torch.obs.slo report --trace results/chaos.trace.json

which re-renders the same tables from a Perfetto trace file — the
exporter embeds each request's decomposition in its root span close
event, so the trace is self-contained.

Everything here is arithmetic over SimClock stamps: deterministic and
replay-stable.
"""
from __future__ import annotations

import argparse
import json
import sys

from .spans import (
    SPAN_DECODE, SPAN_FAULT_RECOVERY, SPAN_PREFILL, SPAN_QUEUE_WAIT,
    SPAN_STALL, RequestTree, SpanTracker,
)

#: the closed set of deadline-miss / shed causes. Attribution picks the
#: phase with the largest time share; ties break in this (priority) order.
CAUSES = ("queue_wait", "prefill", "straggler", "fault_recovery", "shed")

#: shed reasons stamped by the admission queue
SHED_REASONS = ("queue_full", "displaced")


def _pct(xs, q: float) -> float:
    """Nearest-rank percentile (same convention as runtime.metrics)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return float(s[k])


def decompose(tree: RequestTree) -> dict:
    """Per-request decomposition dict from one TERMINAL span tree.

    Phase sums tile ``latency_ms`` (queue_wait + prefill + decode +
    fault_recovery); ``stall_ms`` is carved out of decode — it is the
    deterministic straggler/fault excess inside kept decode rounds, not
    an extra phase. ``ttft_decomp`` tiles ``ttft_ms``: the first token
    arrives at the END of the last fault_recovery episode (prefill
    re-issues it), so TTFT = initial queue_wait + all wasted decode +
    all fault_recovery + (sim-instant) prefill.
    """
    if tree.state == "open":
        raise ValueError(f"request {tree.rid}: cannot decompose an open tree")
    phases = tree.phases()

    def total(name):
        return sum(p.dur_ms for p in phases if p.name == name)

    queue_wait = phases[0].dur_ms if phases and \
        phases[0].name == SPAN_QUEUE_WAIT else 0.0
    prefill = total(SPAN_PREFILL)
    fault_recovery = total(SPAN_FAULT_RECOVERY)
    wasted_decode = sum(p.dur_ms for p in phases
                        if p.name == SPAN_DECODE and p.args.get("wasted"))
    kept_decode = total(SPAN_DECODE) - wasted_decode
    # stall inside KEPT rounds only: wasted rounds are already charged to
    # fault_recovery wholesale, so their stalls must not also count as
    # straggler time (the attribution shares stay disjoint)
    stall = sum(s.dur_ms for p in phases
                if p.name == SPAN_DECODE and not p.args.get("wasted")
                for s in p.walk() if s.name == SPAN_STALL)

    latency = (tree.finished_ms - tree.arrival_ms) \
        if tree.finished_ms is not None else 0.0
    n_tokens = int(tree.root.args.get("n_tokens", 0))
    ttft = tree.root.args.get("ttft_ms")
    if ttft is None:  # shed before any token
        ttft = latency
    # decode time per generated token after the first
    tpot = (kept_decode / (n_tokens - 1)) if n_tokens > 1 else 0.0

    deadline = tree.deadline_ms
    missed = bool(tree.state == "shed" or
                  (deadline is not None and tree.finished_ms is not None
                   and tree.finished_ms > deadline))

    row = {
        "rid": tree.rid,
        "state": tree.state,
        "latency_ms": latency,
        "ttft_ms": float(ttft),
        "tpot_ms": tpot,
        "n_tokens": n_tokens,
        "n_requeues": int(tree.root.args.get("n_requeues", 0)),
        "queue_wait_ms": queue_wait,
        "prefill_ms": prefill,
        "decode_ms": kept_decode,
        "stall_ms": stall,
        "fault_recovery_ms": fault_recovery + wasted_decode,
        "ttft_decomp": {
            "queue_wait": queue_wait,
            "prefill": prefill,
            "fault_recovery": fault_recovery + wasted_decode,
        },
        "missed": missed,
        "shed_reason": tree.root.args.get("shed_reason"),
    }
    row["cause"] = attribute(row) if missed else None
    return row


def attribute(row: dict) -> str:
    """Dominant-cause attribution for one missed/shed request — exactly
    one cause from ``CAUSES``. Sheds are attributed to ``shed``
    unconditionally (the depth bound, not a phase, killed the request);
    otherwise the largest contributor wins, ties broken by ``CAUSES``
    order (earlier pipeline stages take precedence: a request that spent
    equal time queued and stalled missed because admission was late)."""
    if row["state"] == "shed":
        return "shed"
    shares = {
        "queue_wait": row["queue_wait_ms"],
        "prefill": row["prefill_ms"],
        "straggler": row["stall_ms"],
        "fault_recovery": row["fault_recovery_ms"],
    }
    best = max(shares.values())
    for cause in CAUSES:
        if cause in shares and shares[cause] >= best - 1e-9:
            return cause
    return "queue_wait"  # unreachable: shares is non-empty


def decompositions(tracker: SpanTracker) -> list[dict]:
    """Decompose every terminal tree (rid-ordered)."""
    return [decompose(t) for t in tracker.terminal()]


def summarize(rows_or_tracker) -> dict:
    """Aggregate decomposition rows into the SLO summary block used by
    the Prometheus exporter and the CLI tables."""
    rows = rows_or_tracker
    if isinstance(rows_or_tracker, SpanTracker):
        rows = decompositions(rows_or_tracker)
    rows = list(rows)
    done = [r for r in rows if r["state"] == "completed"]
    ttft = [r["ttft_ms"] for r in done]
    tpot = [r["tpot_ms"] for r in done if r["n_tokens"] > 1]
    miss_by_cause = {c: 0 for c in CAUSES}
    shed_by_reason = {s: 0 for s in SHED_REASONS}
    for r in rows:
        if r["missed"]:
            miss_by_cause[r["cause"]] += 1
        if r["state"] == "shed" and r.get("shed_reason"):
            shed_by_reason.setdefault(r["shed_reason"], 0)
            shed_by_reason[r["shed_reason"]] += 1

    def phase_pcts(key):
        vals = [r[key] for r in done]
        return {"p50_ms": _pct(vals, 50), "p99_ms": _pct(vals, 99)}

    return {
        "n_requests": len(rows),
        "n_completed": len(done),
        "n_shed": sum(1 for r in rows if r["state"] == "shed"),
        "n_missed": sum(1 for r in rows if r["missed"]),
        "ttft_p50_ms": _pct(ttft, 50),
        "ttft_p99_ms": _pct(ttft, 99),
        "tpot_p50_ms": _pct(tpot, 50),
        "tpot_p99_ms": _pct(tpot, 99),
        "decomp": {
            "queue_wait": phase_pcts("queue_wait_ms"),
            "prefill": phase_pcts("prefill_ms"),
            "decode": phase_pcts("decode_ms"),
            "stall": phase_pcts("stall_ms"),
            "fault_recovery": phase_pcts("fault_recovery_ms"),
        },
        "miss_by_cause": miss_by_cause,
        "shed_by_reason": shed_by_reason,
    }


def prometheus_lines(summary: dict) -> list[str]:
    """``repro_slo_*`` Prometheus exposition lines from a summary."""
    out = [
        "# HELP repro_slo_ttft_ms Time-to-first-token percentiles (sim ms).",
        "# TYPE repro_slo_ttft_ms gauge",
        f'repro_slo_ttft_ms{{quantile="0.5"}} {summary["ttft_p50_ms"]}',
        f'repro_slo_ttft_ms{{quantile="0.99"}} {summary["ttft_p99_ms"]}',
        "# HELP repro_slo_tpot_ms Time-per-output-token percentiles (sim ms).",
        "# TYPE repro_slo_tpot_ms gauge",
        f'repro_slo_tpot_ms{{quantile="0.5"}} {summary["tpot_p50_ms"]}',
        f'repro_slo_tpot_ms{{quantile="0.99"}} {summary["tpot_p99_ms"]}',
        "# HELP repro_slo_deadline_miss_total Deadline misses by dominant cause.",
        "# TYPE repro_slo_deadline_miss_total counter",
    ]
    for cause in CAUSES:
        out.append(f'repro_slo_deadline_miss_total{{cause="{cause}"}} '
                   f'{summary["miss_by_cause"].get(cause, 0)}')
    out += [
        "# HELP repro_slo_shed_total Requests shed by the admission queue, by reason.",
        "# TYPE repro_slo_shed_total counter",
    ]
    for reason in sorted(set(SHED_REASONS) | set(summary["shed_by_reason"])):
        out.append(f'repro_slo_shed_total{{reason="{reason}"}} '
                   f'{summary["shed_by_reason"].get(reason, 0)}')
    for phase in ("queue_wait", "prefill", "decode", "stall",
                  "fault_recovery"):
        p = summary["decomp"][phase]
        out += [
            f'repro_slo_phase_ms{{phase="{phase}",quantile="0.5"}} '
            f'{p["p50_ms"]}',
            f'repro_slo_phase_ms{{phase="{phase}",quantile="0.99"}} '
            f'{p["p99_ms"]}',
        ]
    return out


# ---------------------------------------------------------------- CLI ----

def rows_from_trace(trace: dict) -> list[dict]:
    """Recover per-request decomposition rows from a Perfetto trace file:
    the exporter embeds each row in the root span's async-end event."""
    rows = []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "e" and ev.get("name") == "request":
            decomp = (ev.get("args") or {}).get("slo")
            if decomp is not None:
                rows.append(decomp)
    return sorted(rows, key=lambda r: r["rid"])


def _fmt_table(headers, rows) -> str:
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows)) if rows
              else len(str(h)) for i, h in enumerate(headers)]
    line = "  ".join(str(h).ljust(w) for h, w in zip(headers, widths))
    sep = "  ".join("-" * w for w in widths)
    body = "\n".join("  ".join(str(c).ljust(w) for c, w in zip(r, widths))
                     for r in rows)
    return "\n".join([line, sep, body] if rows else [line, sep])


def render_report(rows: list[dict]) -> str:
    """Human-readable SLO report (the ``report`` subcommand's output)."""
    s = summarize(rows)
    ms = lambda v: f"{v:.2f}"
    out = [
        f"requests: {s['n_requests']}  completed: {s['n_completed']}  "
        f"shed: {s['n_shed']}  deadline-missed: {s['n_missed']}",
        "",
        "latency percentiles (sim ms)",
        _fmt_table(
            ["metric", "p50", "p99"],
            [["ttft_ms", ms(s["ttft_p50_ms"]), ms(s["ttft_p99_ms"])],
             ["tpot_ms", ms(s["tpot_p50_ms"]), ms(s["tpot_p99_ms"])]]),
        "",
        "per-phase decomposition (sim ms, completed requests)",
        _fmt_table(
            ["phase", "p50", "p99"],
            [[ph, ms(s["decomp"][ph]["p50_ms"]), ms(s["decomp"][ph]["p99_ms"])]
             for ph in ("queue_wait", "prefill", "decode", "stall",
                        "fault_recovery")]),
    ]
    if s["n_missed"]:
        out += ["", "deadline misses by dominant cause",
                _fmt_table(["cause", "count"],
                           [[c, n] for c, n in s["miss_by_cause"].items()
                            if n])]
    if s["n_shed"]:
        out += ["", "sheds by reason",
                _fmt_table(["reason", "count"],
                           [[c, n] for c, n in s["shed_by_reason"].items()
                            if n])]
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.slo",
        description="Render SLO breakdown tables from a Perfetto trace "
                    "produced by repro_torch.launch.serve --trace.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser("report", help="p50/p99 TTFT/TPOT decomposition "
                                        "and miss attribution tables")
    rep.add_argument("--trace", required=True,
                     help="chrome trace JSON written by --trace")
    rep.add_argument("--json", action="store_true",
                     help="emit the summary as JSON instead of tables")
    args = ap.parse_args(argv)

    with open(args.trace) as f:
        trace = json.load(f)
    rows = rows_from_trace(trace)
    if not rows:
        print("no request spans with slo decompositions found in "
              f"{args.trace}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(summarize(rows), indent=2, sort_keys=True))
    else:
        print(render_report(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
