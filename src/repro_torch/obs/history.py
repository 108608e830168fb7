"""Benchmark trajectory: schema-versioned snapshots + a regression gate.

The port's copy of the reference package's ``obs/history.py``: the same
schema, tolerances, comparator and CLI, so that either package reads and
gates the other's history file. Host code only; it touches no device.

``BENCH_*.json`` artifacts are overwritten on every run — a perf
regression that lands between two snapshots is invisible. Every bench run
therefore APPENDS one record per (bench, arch) to ``BENCH_history.jsonl``:

    {"schema": 1, "ts": ..., "git_sha": "...", "bench": "serve_throughput",
     "arch": "granite-3-8b",
     "metrics": {"rounds_per_s": ..., "ttft_p99_ms": ...,
                 "roofline_utilization": ..., "coded_overhead_frac": ...,
                 "model_flops": ..., "achieved_flops_per_s": ...}}

The comparator checks the LAST record of each (bench, arch) group against
the median of the previous ``last_n`` records, per metric, with a
direction-aware relative tolerance:

  * ``higher`` (throughput-like: rounds_per_s, achieved_flops_per_s,
    roofline_utilization) — regression when the candidate falls more than
    ``rel`` below the baseline median;
  * ``lower``  (latency-like: ttft_p99_ms) — regression when it rises
    more than ``rel`` above;
  * ``match``  (deterministic: model_flops, coded_overhead_frac) —
    regression when it drifts more than ``rel`` in either direction.

Wall-clock metrics get loose defaults (machine noise); deterministic ones
are tight. ``--tolerance`` loosens a metric further for a comparison
across machines; ``--inject-slowdown`` demonstrates the gate: a synthetic
candidate built from the baseline itself with every throughput metric
scaled down (and every latency metric scaled up) by the given fraction —
deterministic, so the gate MUST fire.

CLI:  python -m repro_torch.obs.history append --path BENCH_history.jsonl \
          --bench serve_throughput --arch granite-3-8b \
          --metric rounds_per_s=123.4
      python -m repro_torch.obs.history check --path BENCH_history.jsonl \
          [--bench B] [--arch A] [--last-n 5] [--tolerance name=rel] \
          [--inject-slowdown 0.3]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

SCHEMA_VERSION = 1

#: metric -> (direction, relative tolerance), the reference's.
DEFAULT_TOLERANCES: dict[str, tuple[str, float]] = {
    "rounds_per_s": ("higher", 0.25),
    "tokens_per_s": ("higher", 0.25),
    "achieved_flops_per_s": ("higher", 0.50),
    "roofline_utilization": ("higher", 0.50),
    "hbm_gbs": ("higher", 0.50),
    "ttft_p99_ms": ("lower", 0.50),
    # TPOT (decode ms per generated token after the first, from the
    # obs.slo span decomposition): sim-clock-derived, so tighter than the
    # wall-clock latencies; p50 guards the steady decode rate, p99 the
    # straggler tail
    "tpot_p50_ms": ("lower", 0.35),
    "tpot_p99_ms": ("lower", 0.50),
    "p99_latency_ms": ("lower", 0.50),
    "coded_overhead_frac": ("match", 0.05),
    "parity_device_equiv": ("match", 0.05),
    "model_flops": ("match", 0.01),
}


def git_sha(cwd: str | None = None) -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=cwd,
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


# ---------------------------------------------------------------- records ----

def make_snapshot(bench: str, arch: str, metrics: dict, *,
                  sha: str | None = None, ts: float | None = None,
                  extra: dict | None = None) -> dict:
    """One schema-versioned history record (None-valued metrics dropped)."""
    rec = {
        "schema": SCHEMA_VERSION,
        "ts": float(ts) if ts is not None else time.time(),
        "git_sha": sha if sha is not None else git_sha(),
        "bench": str(bench),
        "arch": str(arch),
        "metrics": {k: float(v) for k, v in metrics.items()
                    if isinstance(v, (int, float))},
    }
    if extra:
        rec["extra"] = extra
    return rec


def append_snapshot(path: str, bench: str, arch: str, metrics: dict,
                    **kw) -> dict:
    """Append one record to the JSONL history (creating it if needed)."""
    rec = make_snapshot(bench, arch, metrics, **kw)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec, sort_keys=True) + "\n")
    return rec


def load_history(path: str) -> list[dict]:
    """Parse the JSONL history; unparsable lines and records from a NEWER
    schema are skipped (forward compatibility), order preserved."""
    records: list[dict] = []
    if not os.path.exists(path):
        return records
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(rec, dict) or "metrics" not in rec:
                continue
            if int(rec.get("schema", 0)) > SCHEMA_VERSION:
                continue
            records.append(rec)
    return records


# ------------------------------------------------------------- comparison ----

def _tolerances(overrides: dict | None) -> dict:
    tol = dict(DEFAULT_TOLERANCES)
    for name, rel in (overrides or {}).items():
        direction = tol.get(name, ("match", 0.0))[0]
        tol[name] = (direction, float(rel))
    return tol


def compare(candidate: dict, baseline_records: list[dict],
            tolerances: dict | None = None, last_n: int = 5) -> list[dict]:
    """Regressions of ``candidate`` vs the per-metric median of the last
    ``last_n`` baseline records. Returns one dict per violated metric;
    metrics missing on either side are skipped (never a false alarm)."""
    tol = _tolerances(tolerances)
    window = baseline_records[-last_n:]
    regressions = []
    for metric, (direction, rel) in sorted(tol.items()):
        cand = candidate.get("metrics", {}).get(metric)
        if cand is None:
            continue
        base_vals = [r["metrics"][metric] for r in window
                     if metric in r.get("metrics", {})]
        if not base_vals:
            continue
        base = statistics.median(base_vals)
        scale = abs(base) if base else 1.0
        if direction == "higher":
            bad = cand < base - rel * scale
        elif direction == "lower":
            bad = cand > base + rel * scale
        else:  # match
            bad = abs(cand - base) > rel * scale
        if bad:
            regressions.append({
                "metric": metric, "direction": direction,
                "tolerance": rel, "baseline_median": base,
                "candidate": cand, "n_baseline": len(base_vals),
                "rel_change": (cand - base) / scale,
            })
    return regressions


def synthetic_slowdown(baseline_records: list[dict], frac: float,
                       tolerances: dict | None = None,
                       last_n: int = 5) -> dict:
    """A synthetic candidate: the baseline medians with every ``higher``
    metric scaled by (1 - frac) and every ``lower`` metric by (1 + frac)
    — the deterministic demonstration that the gate fires."""
    tol = _tolerances(tolerances)
    window = baseline_records[-last_n:]
    metrics: dict[str, float] = {}
    for metric, (direction, _) in tol.items():
        vals = [r["metrics"][metric] for r in window
                if metric in r.get("metrics", {})]
        if not vals:
            continue
        base = statistics.median(vals)
        if direction == "higher":
            metrics[metric] = base * (1.0 - frac)
        elif direction == "lower":
            metrics[metric] = base * (1.0 + frac)
        else:
            metrics[metric] = base
    return make_snapshot("synthetic", "synthetic", metrics, sha="synthetic")


def check_history(path: str, bench: str | None = None,
                  arch: str | None = None, last_n: int = 5,
                  tolerances: dict | None = None,
                  inject_slowdown: float = 0.0) -> list[dict]:
    """Gate every (bench, arch) group in the history file. Each group's
    LAST record is compared against the median of its predecessors (a
    group with a single record has no baseline and passes trivially
    unless a slowdown is injected, in which case the synthetic candidate
    is judged against the whole group). Returns one result dict per
    group: {bench, arch, candidate, n_baseline, regressions}."""
    groups: dict[tuple[str, str], list[dict]] = {}
    for rec in load_history(path):
        if bench is not None and rec.get("bench") != bench:
            continue
        if arch is not None and rec.get("arch") != arch:
            continue
        groups.setdefault((rec.get("bench", "?"), rec.get("arch", "?")),
                          []).append(rec)
    results = []
    for (b, a), recs in sorted(groups.items()):
        if inject_slowdown > 0:
            candidate = synthetic_slowdown(recs, inject_slowdown,
                                           tolerances, last_n)
            baseline = recs
        else:
            candidate, baseline = recs[-1], recs[:-1]
        results.append({
            "bench": b, "arch": a,
            "candidate_sha": candidate.get("git_sha"),
            "n_baseline": min(len(baseline), last_n),
            "regressions": compare(candidate, baseline, tolerances, last_n),
        })
    return results


# -------------------------------------------------------------------- CLI ----

def _parse_kv(pairs: list[str], what: str) -> dict:
    out = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"--{what} wants name=value, got {p!r}")
        k, v = p.split("=", 1)
        out[k] = float(v)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.obs.history")
    sub = ap.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("append", help="append one snapshot")
    a.add_argument("--path", default="BENCH_history.jsonl")
    a.add_argument("--bench", required=True)
    a.add_argument("--arch", required=True)
    a.add_argument("--metric", action="append", default=[],
                   metavar="NAME=VALUE")

    c = sub.add_parser("check", help="regression gate over the history")
    c.add_argument("--path", default="BENCH_history.jsonl")
    c.add_argument("--bench", default=None)
    c.add_argument("--arch", default=None)
    c.add_argument("--last-n", type=int, default=5)
    c.add_argument("--tolerance", action="append", default=[],
                   metavar="NAME=REL",
                   help="override a metric's relative tolerance")
    c.add_argument("--inject-slowdown", type=float, default=0.0,
                   help="judge a synthetic candidate built from the "
                        "baseline with this fractional slowdown (gate "
                        "demonstration: MUST exit 1)")
    args = ap.parse_args(argv)

    if args.cmd == "append":
        rec = append_snapshot(args.path, args.bench, args.arch,
                              _parse_kv(args.metric, "metric"))
        print(json.dumps(rec, sort_keys=True))
        return 0

    results = check_history(args.path, bench=args.bench, arch=args.arch,
                            last_n=args.last_n,
                            tolerances=_parse_kv(args.tolerance,
                                                 "tolerance"),
                            inject_slowdown=args.inject_slowdown)
    if not results:
        print(f"history check: no records in {args.path}")
        return 0
    failed = False
    for res in results:
        tag = f"{res['bench']}/{res['arch']}"
        if res["regressions"]:
            failed = True
            print(f"REGRESSION {tag} (baseline n={res['n_baseline']}):")
            for reg in res["regressions"]:
                print(f"  {reg['metric']}: {reg['candidate']:.6g} vs "
                      f"median {reg['baseline_median']:.6g} "
                      f"({reg['rel_change']:+.1%}, {reg['direction']} "
                      f"tol {reg['tolerance']:.0%})")
        else:
            print(f"ok {tag} (baseline n={res['n_baseline']})")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
