"""Exporters for the flight recorder: Perfetto/Chrome trace JSON and
Prometheus text-format metrics, plus a tiny live exposition server (the
port's own copy of the reference package's host-only ``obs/export.py``).

Chrome ``trace_event`` format (loadable at https://ui.perfetto.dev or
chrome://tracing): one process ("repro_torch.runtime"), one thread per track —
``requests``, ``rounds``, ``planner``, one per decode slot
(``slot:<i>``), one per coded shard (``shard:<i>``). Timestamps are the
runtime's SIMULATED clock in microseconds (deterministic, so a replayed
chaos run exports a byte-identical trace modulo wall fields); the wall
stamps ride along in each event's ``args`` under ``wall_*`` keys.
``ShardTimeline`` down-intervals render as red-able "down" slices on the
shard tracks, so per-shard unavailability is visible at a glance.

``validate_chrome_trace`` is the schema + causality checker CI runs on
every traced chaos artifact: structural validity (required keys, known
phases, non-negative spans) and the paper's recovery claim as a trace
property — EVERY ``fault.inject`` erasure must be resolved by a matching
``fault.recovered`` (in-step CDC), a ``fault.beyond_budget`` followed by
the ``shard.heal_all`` + ``code.reencode`` 2MR chain, or an explicit
``fault.noop`` (duplicate report of an already-dead shard).

``prometheus_text`` renders ``RuntimeMetrics`` (counters -> ``_total``
counters, bounded histograms -> ``_bucket/_sum/_count`` series) plus
per-shard duty-cycle gauges; ``MetricsServer`` serves it at
``/metrics`` (and the live trace at ``/trace``) from a daemon thread —
``launch/serve.py --metrics-port`` wires it up.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from repro_torch.obs.tracer import FlightRecorder

_PROCESS = "repro_torch.runtime"
_KNOWN_PHASES = {"X", "i", "I", "M", "b", "e", "n", "s", "t", "f", "C"}


# ---------------------------------------------------------- chrome trace ----

def _track_order(tracks: list[str]) -> list[str]:
    """Stable display order: requests, spans, rounds, planner, perf,
    slots, shards."""
    def key(t: str):
        head, _, idx = t.partition(":")
        fixed = {"requests": 0, "spans": 1, "rounds": 2, "planner": 3,
                 "perf": 4, "slot": 5, "shard": 6}
        return (fixed.get(head, 7), int(idx) if idx.isdigit() else 0, t)
    return sorted(set(tracks), key=key)


def chrome_trace(recorder: FlightRecorder, shardlog=None,
                 now_ms: float | None = None,
                 meta: dict | None = None, spans=None) -> dict:
    """Serialise the recorder (and optional shard timeline and
    ``SpanTracker``) as a Chrome ``trace_event`` JSON object. Terminal
    request span trees render as async b/e events on a dedicated
    ``spans`` track, with flow arrows ("s"/"f" pairs) from each round's
    dispatch event to the decode slices that rode it and from each
    injected fault's position to the ``fault_recovery`` span it caused;
    each root span's end event embeds the ``obs.slo`` decomposition, so
    the trace file is a self-contained SLO report."""
    events = recorder.events()
    tracks = [e.track for e in events]
    if shardlog is not None:
        tracks += [f"shard:{i}" for i in range(shardlog.n_shards)]
    if spans is not None and len(spans.done):
        tracks += ["spans", "rounds"]
    order = _track_order(tracks)
    tid = {t: i + 1 for i, t in enumerate(order)}

    out: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
        "args": {"name": _PROCESS},
    }]
    for t in order:
        out.append({"name": "thread_name", "ph": "M", "pid": 1,
                    "tid": tid[t], "args": {"name": t}})
        out.append({"name": "thread_sort_index", "ph": "M", "pid": 1,
                    "tid": tid[t], "args": {"sort_index": tid[t]}})

    for e in events:
        args = dict(e.args)
        args["wall_ms"] = e.wall_ms
        if e.wall_dur_ms:
            args["wall_dur_ms"] = e.wall_dur_ms
        for k, v in e.wall_args.items():
            args[f"wall_{k}"] = v
        rec = {
            "name": e.kind,
            "cat": e.kind.split(".", 1)[0],
            "pid": 1,
            "tid": tid[e.track],
            "ts": e.t_ms * 1e3,          # trace_event wants microseconds
            "args": args,
        }
        if e.kind == "perf.counter":
            # Perfetto counter sample: every numeric arg becomes a series
            # on the perf track (strings would chart as garbage)
            rec["ph"] = "C"
            rec["args"] = {k: v for k, v in args.items()
                           if isinstance(v, (int, float))
                           and not isinstance(v, bool)}
        elif e.dur_ms > 0:
            rec["ph"], rec["dur"] = "X", e.dur_ms * 1e3
        else:
            rec["ph"], rec["s"] = "i", "t"
        out.append(rec)

    if shardlog is not None:
        for shard, t0, t1, cause in shardlog.all_intervals(now_ms):
            out.append({
                "name": "down", "cat": "health", "ph": "X", "pid": 1,
                "tid": tid[f"shard:{shard}"], "ts": t0 * 1e3,
                "dur": max(t1 - t0, 0.0) * 1e3,
                "args": {"shard": shard, "healed_by": cause},
            })

    if spans is not None and len(spans.done):
        _emit_span_events(out, spans, tid, events)

    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "exporter": "repro_torch.obs",
            "clock": "simulated-ms (wall stamps in args.wall_*)",
            "n_events": len(events),
            "dropped_events": recorder.dropped,
            **(meta or {}),
        },
    }


def _span_args(sp) -> dict:
    """Span args with the wall-clock fields folded in under ``wall_*``
    keys (same quarantine convention as ``TraceEvent`` export)."""
    args = dict(sp.args)
    args["wall_t0_ms"] = sp.wall_t0_ms
    for k, v in sp.wall_args.items():
        args[f"wall_{k}"] = v
    return args


def _emit_span_events(out: list, spans, tid: dict, events) -> None:
    """Render terminal request span trees as async b/e events plus the
    two flow-arrow families (round -> decode slice, injected fault ->
    fault_recovery span)."""
    from repro_torch.obs.slo import decompose
    from repro_torch.obs.spans import SPAN_FAULT_RECOVERY, SPAN_SLICE

    span_tid = tid["spans"]
    rounds_tid = tid.get("rounds", span_tid)
    # anchor lookup: dispatch id -> its round.dispatch event's sim ts
    round_ts = {e.args["round"]: e.t_ms * 1e3 for e in events
                if e.kind == "round.dispatch" and "round" in e.args}

    def emit(sp, rid):
        rec = {"name": sp.name, "cat": "span", "ph": "b", "pid": 1,
               "tid": span_tid, "id": str(rid), "ts": sp.t0_ms * 1e3,
               "args": _span_args(sp)}
        out.append(rec)
        if sp.name == SPAN_SLICE and "round" in sp.args:
            ridx = sp.args["round"]
            flow = {"name": "rode-round", "cat": "flow", "pid": 1,
                    "id": f"round{ridx}:rid{rid}"}
            out.append({**flow, "ph": "s", "tid": rounds_tid,
                        "ts": round_ts.get(ridx, sp.t0_ms * 1e3)})
            out.append({**flow, "ph": "f", "bp": "e", "tid": span_tid,
                        "ts": sp.t0_ms * 1e3})
        if sp.name == SPAN_FAULT_RECOVERY and "fault_t_ms" in sp.args:
            flow_id = (f"fault:s{sp.args.get('fault_shard', -1)}"
                       f"@{sp.args['fault_t_ms']}:rid{rid}")
            rec["args"]["flow_id"] = flow_id
            anchor = tid.get(f"shard:{sp.args.get('fault_shard')}",
                             rounds_tid)
            flow = {"name": "caused-requeue", "cat": "flow", "pid": 1,
                    "id": flow_id}
            out.append({**flow, "ph": "s", "tid": anchor,
                        "ts": sp.args["fault_t_ms"] * 1e3})
            out.append({**flow, "ph": "f", "bp": "e", "tid": span_tid,
                        "ts": sp.t0_ms * 1e3})
        for child in sp.children:
            emit(child, rid)
        end = {"name": sp.name, "cat": "span", "ph": "e", "pid": 1,
               "tid": span_tid, "id": str(rid), "ts": sp.t1_ms * 1e3,
               "args": {}}
        if sp.name == "request":
            # the trace is a self-contained SLO report: the CLI
            # (python -m repro_torch.obs.slo report) reads these back
            end["args"]["slo"] = decompose(tree)
        out.append(end)

    for tree in spans.terminal():
        emit(tree.root, tree.rid)


def write_chrome_trace(path: str, recorder: FlightRecorder, shardlog=None,
                       now_ms: float | None = None,
                       meta: dict | None = None, spans=None) -> dict:
    trace = chrome_trace(recorder, shardlog, now_ms, meta, spans=spans)
    with open(path, "w") as f:
        json.dump(trace, f, indent=1, sort_keys=True)
    return trace


# ------------------------------------------------------------ validation ----

def validate_chrome_trace(trace: Any, require_fault_links: bool = False,
                          require_perf_counters: bool = False,
                          require_span_closure: bool = False) -> dict:
    """Structural + causal validation; raises ``ValueError`` on the first
    violation, returns summary stats otherwise. With
    ``require_fault_links=True`` the trace must contain at least one
    injected fault AND every injected erasure must be linked to its
    resolution (the CI chaos artifact contract). With
    ``require_perf_counters=True`` it must carry at least one counter
    ("C") sample on the ``perf`` track (the perf-observability contract
    for perf-enabled runs). With ``require_span_closure=True`` the trace
    must carry at least one request span tree and EVERY tree must satisfy
    the span contract — checked on any trace that has span events: every
    b has a matching e (same async id + name, properly nested), top-level
    phases tile the root gap-free, decode slices tile their decode span,
    every deadline miss carries exactly one attributed cause, and every
    ``fault_recovery`` span's flow arrow resolves to an s/f pair (0
    unlinked)."""
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be a dict with a traceEvents list")
    events = trace["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    names: dict[int, str] = {}
    n_counters = 0
    perf_counters = 0
    for i, e in enumerate(events):
        for key in ("name", "ph", "pid", "tid"):
            if key not in e:
                raise ValueError(f"event {i} missing {key!r}: {e}")
        if e["ph"] not in _KNOWN_PHASES:
            raise ValueError(f"event {i} has unknown phase {e['ph']!r}")
        if e["ph"] == "M":
            if e["name"] == "thread_name":
                names[e["tid"]] = e["args"]["name"]
            continue
        if "ts" not in e:
            raise ValueError(f"event {i} missing ts: {e}")
        if e["ts"] < 0:
            raise ValueError(f"event {i} has negative ts: {e}")
        if e["ph"] == "X" and e.get("dur", 0) < 0:
            raise ValueError(f"event {i} has negative dur: {e}")
        if e["tid"] not in names and e["tid"] != 0:
            raise ValueError(f"event {i} on unnamed track tid={e['tid']}")
        if e["ph"] == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not args or any(
                    not isinstance(v, (int, float)) or isinstance(v, bool)
                    for v in args.values()):
                raise ValueError(f"counter event {i} must carry a "
                                 f"non-empty all-numeric args dict: {e}")
            n_counters += 1
            if names.get(e["tid"]) == "perf":
                perf_counters += 1

    injected = [e for e in events if e["name"] == "fault.inject"]
    erasures = [e for e in injected if e["args"].get("fault") == "erasure"]

    def _after(name: str, ts: float, shard: int | None = None):
        return [e for e in events
                if e["name"] == name and e["ts"] >= ts
                and (shard is None or e["args"].get("shard") == shard)]

    linked = 0
    for f in erasures:
        ts, shard = f["ts"], f["args"]["shard"]
        if _after("fault.recovered", ts, shard) or _after("fault.noop",
                                                          ts, shard):
            linked += 1
            continue
        beyond = _after("fault.beyond_budget", ts)
        if beyond and _after("shard.heal_all", beyond[0]["ts"]) \
                and _after("code.reencode", beyond[0]["ts"]):
            linked += 1
            continue
        raise ValueError(
            f"injected erasure on shard {shard} at ts={ts} has no "
            "recovery/requeue-heal-reencode/noop resolution in the trace")

    if require_fault_links and not erasures:
        raise ValueError("trace contains no injected erasures "
                         "(require_fault_links=True)")
    if require_perf_counters and perf_counters == 0:
        raise ValueError("trace carries no counter samples on the 'perf' "
                         "track (require_perf_counters=True)")
    span_stats = _validate_spans(events, require_span_closure)
    return {
        "n_events": sum(1 for e in events if e["ph"] != "M"),
        "n_tracks": len(names),
        "n_injected": len(injected),
        "n_injected_erasures": len(erasures),
        "n_linked": linked,
        "n_counters": n_counters,
        "n_perf_counters": perf_counters,
        "dropped_events": trace.get("otherData", {}).get("dropped_events",
                                                         0),
        **span_stats,
    }


#: tiling tolerance for span gap accounting, in trace_event µs
_SPAN_EPS_US = 0.5


def _validate_spans(events: list, require: bool) -> dict:
    """The span contract (see ``validate_chrome_trace``): applied to any
    trace carrying ``cat="span"`` async events; ``require=True``
    additionally demands that span trees exist at all."""
    from repro_torch.obs.slo import CAUSES

    trees: dict[str, list] = {}          # async id -> root nodes
    stacks: dict[str, list] = {}
    flow_ids = {e["id"] for e in events
                if e.get("cat") == "flow" and e["ph"] in ("s", "t", "f")}
    flow_starts = {e["id"] for e in events
                   if e.get("cat") == "flow" and e["ph"] == "s"}
    flow_ends = {e["id"] for e in events
                 if e.get("cat") == "flow" and e["ph"] == "f"}
    n_fr = n_unlinked_fr = 0
    for i, e in enumerate(events):
        if e.get("cat") != "span":
            continue
        if "id" not in e:
            raise ValueError(f"span event {i} missing async id: {e}")
        sid = e["id"]
        if e["ph"] == "b":
            node = {"name": e["name"], "ts": e["ts"], "t1": None,
                    "args": e.get("args", {}), "children": []}
            stack = stacks.setdefault(sid, [])
            if stack:
                stack[-1]["children"].append(node)
            else:
                trees.setdefault(sid, []).append(node)
            stack.append(node)
            if e["name"] == "fault_recovery":
                n_fr += 1
                fid = node["args"].get("flow_id")
                if fid is None or fid not in flow_starts \
                        or fid not in flow_ends:
                    n_unlinked_fr += 1
        elif e["ph"] == "e":
            stack = stacks.get(sid)
            if not stack:
                raise ValueError(f"span end without open span (id={sid}, "
                                 f"name={e['name']})")
            node = stack.pop()
            if node["name"] != e["name"]:
                raise ValueError(
                    f"span nesting violation for id={sid}: closing "
                    f"{e['name']!r} but {node['name']!r} is open")
            if e["ts"] < node["ts"]:
                raise ValueError(f"span {e['name']!r} (id={sid}) closes "
                                 "before it opens")
            node["t1"] = e["ts"]
            node["end_args"] = e.get("args", {})

    for sid, stack in stacks.items():
        if stack:
            raise ValueError(
                f"unclosed span(s) for id={sid}: "
                f"{[n['name'] for n in stack]} (span contract requires "
                "every request tree closed)")

    n_missed = n_slices = n_roots = 0
    for sid, roots in trees.items():
        for root in roots:
            if root["name"] != "request":
                raise ValueError(f"top-level span {root['name']!r} "
                                 f"(id={sid}) is not a request root")
            n_roots += 1
            # gap accounting: phases tile the root, slices tile decode
            t = root["ts"]
            for ph in root["children"]:
                if abs(ph["ts"] - t) > _SPAN_EPS_US:
                    raise ValueError(
                        f"request {sid}: gap before {ph['name']!r} phase "
                        f"({t} -> {ph['ts']} us)")
                t = ph["t1"]
                if ph["name"] == "decode":
                    ts = ph["ts"]
                    for sl in ph["children"]:
                        if sl["name"] != "decode.round":
                            raise ValueError(
                                f"request {sid}: {sl['name']!r} directly "
                                "under decode")
                        if abs(sl["ts"] - ts) > _SPAN_EPS_US:
                            raise ValueError(
                                f"request {sid}: decode slice gap "
                                f"({ts} -> {sl['ts']} us)")
                        ts = sl["t1"]
                        n_slices += 1
                    if abs(ts - ph["t1"]) > _SPAN_EPS_US:
                        raise ValueError(
                            f"request {sid}: decode slices end at {ts}, "
                            f"span at {ph['t1']} us")
            if abs(t - root["t1"]) > _SPAN_EPS_US:
                raise ValueError(
                    f"request {sid}: phases end at {t}, root at "
                    f"{root['t1']} us (gap in the span tree)")
            slo = root.get("end_args", {}).get("slo")
            if slo is not None and slo.get("missed"):
                n_missed += 1
                cause = slo.get("cause")
                if cause not in CAUSES:
                    raise ValueError(
                        f"request {sid}: deadline miss with invalid "
                        f"cause {cause!r} (must be one of {CAUSES})")

    if require:
        if n_roots == 0:
            raise ValueError("trace carries no request span trees "
                             "(require_span_closure=True)")
        if n_unlinked_fr:
            raise ValueError(
                f"{n_unlinked_fr} fault_recovery span(s) lack a resolved "
                "flow arrow to their injector fault "
                "(require_span_closure=True)")
    return {
        "n_span_trees": n_roots,
        "n_span_slices": n_slices,
        "n_span_missed": n_missed,
        "n_fault_recovery_spans": n_fr,
        "n_unlinked_fault_recovery": n_unlinked_fr,
        "n_flow_ids": len(flow_ids),
    }


# ------------------------------------------------------------- prometheus ----

def _prom_hist(lines: list[str], name: str, hist, help_: str):
    lines.append(f"# HELP {name} {help_}")
    lines.append(f"# TYPE {name} histogram")
    cum = 0
    for le, count in hist.buckets():
        cum = count
        le_s = "+Inf" if le == float("inf") else f"{le:g}"
        lines.append(f'{name}_bucket{{le="{le_s}"}} {cum}')
    lines.append(f"{name}_sum {hist.total:g}")
    lines.append(f"{name}_count {hist.n}")


def prometheus_text(metrics, shardlog=None, now_ms: float | None = None,
                    recorder: FlightRecorder | None = None,
                    spans=None) -> str:
    """Render runtime metric state in the Prometheus text exposition
    format (0.0.4). ``metrics`` is a ``RuntimeMetrics``; the optional
    shard timeline adds per-shard duty-cycle gauges, the recorder adds
    trace-buffer meta-series, and a ``SpanTracker`` adds the
    ``repro_slo_*`` family (TTFT/TPOT percentiles, per-phase
    decomposition, deadline misses by dominant cause)."""
    lines: list[str] = []
    lines.append("# HELP repro_runtime_counter Runtime lifecycle counters.")
    lines.append("# TYPE repro_runtime_counter counter")
    for k in sorted(metrics.counters):
        lines.append(f'repro_runtime_counter{{name="{k}"}} '
                     f"{metrics.counters[k]}")
    lines.append("# HELP repro_requests_requeued_total Requests requeued "
                 "by the 2MR beyond-budget fallback.")
    lines.append("# TYPE repro_requests_requeued_total counter")
    lines.append("repro_requests_requeued_total "
                 f"{metrics.counters.get('requests_requeued', 0)}")
    lines.append("# HELP repro_requests_shed_total Requests shed by the "
                 "admission queue, by cause.")
    lines.append("# TYPE repro_requests_shed_total counter")
    shed_causes = getattr(metrics, "shed_causes", {}) or {}
    for cause in sorted(set(shed_causes) | {"queue_full", "displaced"}):
        lines.append(f'repro_requests_shed_total{{cause="{cause}"}} '
                     f"{shed_causes.get(cause, 0)}")
    for name, hist, help_ in (
            ("repro_request_latency_ms", metrics.latencies_ms,
             "Submit-to-last-token request latency (sim ms)."),
            ("repro_request_queueing_ms", metrics.queueing_ms,
             "Queueing delay before final admission (sim ms)."),
            ("repro_request_ttft_ms", metrics.ttft_ms,
             "Time to first token: arrival -> first generated token "
             "(sim ms)."),
            ("repro_round_measured_ms", metrics.round_ms,
             "MEASURED wall-clock decode-round latency (ms).")):
        _prom_hist(lines, name, hist, help_)
    lines.append("# HELP repro_queue_depth Admission queue depth.")
    lines.append("# TYPE repro_queue_depth gauge")
    lines.append(f"repro_queue_depth {metrics.queue_depth.last}")
    lines.append(f"repro_queue_depth_max {metrics.queue_depth.vmax}")
    if shardlog is not None:
        duty = shardlog.duty_cycle(now_ms)
        lines.append("# HELP repro_shard_unavailability Per-shard "
                     "unavailability duty cycle in [0, 1].")
        lines.append("# TYPE repro_shard_unavailability gauge")
        for i, u in enumerate(duty):
            lines.append(f'repro_shard_unavailability{{shard="{i}"}} '
                         f"{float(u):g}")
        lines.append("# HELP repro_shard_erasures_total Per-shard erasure "
                     "count.")
        lines.append("# TYPE repro_shard_erasures_total counter")
        for i in range(shardlog.n_shards):
            lines.append(f'repro_shard_erasures_total{{shard="{i}"}} '
                         f"{int(shardlog.erasures[i])}")
    perf = getattr(metrics, "perf", None)
    if perf:
        lines.append("# HELP repro_perf Roofline-anchored per-round cost "
                     "attribution and achieved rates (obs.perf).")
        lines.append("# TYPE repro_perf gauge")
        for k in sorted(perf):
            v = perf[k]
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            lines.append(f"repro_perf_{k} {float(v):g}")
    if recorder is not None:
        lines.append("# HELP repro_trace_events_total Events emitted to "
                     "the flight recorder.")
        lines.append("# TYPE repro_trace_events_total counter")
        lines.append(f"repro_trace_events_total {recorder.n_emitted}")
        lines.append(f"repro_trace_events_dropped_total {recorder.dropped}")
    if spans is not None and len(spans.done):
        from repro_torch.obs.slo import prometheus_lines, summarize
        lines.extend(prometheus_lines(summarize(spans)))
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Minimal live exposition server: ``/metrics`` (Prometheus text),
    ``/trace`` (current Chrome trace JSON) and ``/healthz`` (liveness
    probe), served from a daemon thread. ``port=0`` binds an ephemeral
    port (tests); read it back from ``server.port``."""

    def __init__(self, metrics, shardlog=None, recorder=None, clock=None,
                 port: int = 0, host: str = "127.0.0.1", spans=None):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):                              # noqa: N802
                if self.path.rstrip("/").endswith("healthz"):
                    body = b"ok\n"
                    ctype = "text/plain; charset=utf-8"
                elif self.path.rstrip("/") in ("", "/metrics", "metrics"):
                    body = outer.render_metrics().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.rstrip("/").endswith("trace"):
                    body = json.dumps(outer.render_trace()).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):                     # quiet
                pass

        self.metrics = metrics
        self.shardlog = shardlog
        self.recorder = recorder
        self.clock = clock
        self.spans = spans
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    def _now(self) -> float | None:
        return self.clock.now() if self.clock is not None else None

    def render_metrics(self) -> str:
        return prometheus_text(self.metrics, self.shardlog, self._now(),
                               self.recorder, spans=self.spans)

    def render_trace(self) -> dict:
        rec = self.recorder if self.recorder is not None \
            else FlightRecorder(capacity=1)
        return chrome_trace(rec, self.shardlog, self._now(),
                            spans=self.spans)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
