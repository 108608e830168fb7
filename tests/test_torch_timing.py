"""The timing flight recorder (``FlightRecorder(timing=True)``) inside the
port, on the CPU at smoke size:

  * on a ``WallClock`` each admission gives one ``host.admit`` span that
    holds, in order and nested, ``host.prefill`` (its state, then its
    forward), ``host.first_token`` and ``host.write_slot``; the request's
    first token is stamped after its prefill, and its span tree's prefill
    ends there;
  * a ``torch.profiler`` trace of the same run holds the host spans and
    the model's ``host.layer.*`` and ``host.head`` ranges, which go off
    again when the recorder is let go;
  * off (``timing=False``), the event stream is the reference package's
    and the snapshot's counters are the reference's; on, it adds the
    ``host.*`` events and the graph counters and nothing else;
  * ``PerfMonitor`` names the source of its round time; the Chrome trace
    draws device spans on a ``device`` track.

The card's test of the device spans is in test_torch_timing_cuda.py (a
file that imports no JAX).
"""
import pytest
import torch

import _torch_sched as ts
from repro.runtime import metrics as jmetrics
from repro_torch.obs import export as texport
from repro_torch.obs import tracer as ttracer
from repro_torch.obs.tracer import HOST_SPANS, FlightRecorder
from repro_torch.runtime import ContinuousBatchingScheduler, RuntimeConfig
from repro_torch.runtime.clock import WallClock

PREFILL_PARTS = ("host.prefill", "host.prefill.state",
                 "host.prefill.forward", "host.first_token",
                 "host.write_slot")
GRAPH_COUNTERS = {"graph_captures", "graph_replays", "graph_drops"}


@pytest.fixture(scope="module")
def pair():
    return ts.make_pair()


def _end(e):
    return e.t_ms + e.dur_ms


def _wall_run(stepper, cfg, n_requests=3, tracer=None):
    """``n_requests`` prompts through two slots on a WallClock."""
    sched = ContinuousBatchingScheduler(
        stepper, RuntimeConfig(n_slots=2), clock=WallClock(),
        tracer=tracer)
    for p in ts.prompts(cfg, n_requests):
        sched.submit(p, 3)
    done = sched.run()
    assert len(done) == n_requests
    return sched, done


@pytest.fixture(scope="module")
def wall(pair):
    """One timed WallClock run under a CPU profiler: (scheduler, done,
    the profiler's range names)."""
    _, stepper, cfg = pair
    rec = FlightRecorder(timing=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sched, done = _wall_run(stepper, cfg, tracer=rec)
    names = {e.name for e in prof.events()}
    sched.attach_tracer(None)
    return sched, rec, done, names


def test_each_admission_nests_its_prefill_read_and_write(wall):
    sched, rec, done, _ = wall
    admits = rec.by_kind("host.admit")
    assert sorted(e.args["rid"] for e in admits) == \
        sorted(r.rid for r in done)
    for a in admits:
        inside = [e for e in rec.events() if e.kind in PREFILL_PARTS
                  and a.t_ms <= e.t_ms and _end(e) <= _end(a)]
        assert [e.kind for e in inside].count("host.prefill") == 1
        got = {e.kind: e for e in inside}
        assert set(got) == set(PREFILL_PARTS)
        pre = got["host.prefill"]
        state, fwd = got["host.prefill.state"], got["host.prefill.forward"]
        assert pre.t_ms <= state.t_ms <= _end(state) <= fwd.t_ms \
            <= _end(fwd) <= _end(pre)
        read, write = got["host.first_token"], got["host.write_slot"]
        assert _end(pre) <= read.t_ms <= _end(read) <= write.t_ms \
            <= _end(write) <= _end(a)
        assert a.args["prompt_len"] == ts.PROMPT_LEN
        assert a.wall_dur_ms >= pre.wall_dur_ms > 0
        # no card: no device time, no allocator
        assert a.wall_args == {}
    assert len(rec.by_kind("host.admit_prefill")) == \
        len(rec.by_kind("host.health")) == sched.metrics.counters[
            "decode_rounds"]


def test_first_token_is_stamped_after_its_prefill(wall):
    sched, rec, done, _ = wall
    prefill_end = {}
    for a in rec.by_kind("host.admit"):
        pre = next(e for e in rec.by_kind("host.prefill")
                   if a.t_ms <= e.t_ms and _end(e) <= _end(a))
        prefill_end[a.args["rid"]] = _end(pre)
    stamps = {e.args["rid"]: e.t_ms
              for e in rec.by_kind("request.first_token")}
    for r in done:
        assert r.first_token_ms >= prefill_end[r.rid] > r.admitted_ms
        assert stamps[r.rid] == r.first_token_ms
        assert r.ttft_ms == r.first_token_ms - r.arrival_ms
        tree = next(t for t in sched.spans.done if t.rid == r.rid)
        pre = next(s for s in tree.root.children if s.name == "prefill")
        assert pre.t1_ms == r.first_token_ms
        assert pre.wall_args["prefill_ms"] > 0


def test_profiler_trace_holds_host_and_model_ranges(wall):
    _, rec, _, names = wall
    assert {e.kind for e in rec.events() if e.kind.startswith("host.")} \
        <= names
    assert set(PREFILL_PARTS) | {"host.admit", "host.admit_prefill",
                                 "host.health", "host.round_dispatch",
                                 "host.harvest_wait"} <= names
    assert {"host.layer.attn", "host.layer.ffn", "host.head"} <= names
    # let go: the model's ranges are off again
    assert ttracer._attached == 0
    assert ttracer.model_range("host.head") is ttracer._NO_SPAN


def test_timing_off_keeps_the_reference_stream_and_counters(pair):
    arrivals = [(i * 2.0, p, 4) for i, p in enumerate(ts.prompts(pair[2],
                                                                 3))]
    events = [("erasure", 3.0, 2)]
    jsched = ts.build_sched(ts.JAX, pair[0], events=events, traced=True,
                            n_slots=2)
    ts.JAX.rt.run_arrivals(jsched, [tuple(a) for a in arrivals])
    plain = ts.build_sched(ts.PORT, pair[1], events=events, traced=True,
                           n_slots=2)
    ts.PORT.rt.run_arrivals(plain, [tuple(a) for a in arrivals])
    assert plain.tracer.comparable() == jsched.tracer.comparable()
    assert set(plain.metrics.counters) == \
        set(jmetrics.RuntimeMetrics().counters)
    # the same run timed: the host spans and the graph counters are all
    # it adds (a recorder attached after construction)
    timed = ts.build_sched(ts.PORT, pair[1], events=events, n_slots=2)
    rec = FlightRecorder(timing=True)
    timed.attach_tracer(rec)
    try:
        ts.PORT.rt.run_arrivals(timed, [tuple(a) for a in arrivals])
    finally:
        timed.attach_tracer(None)
    assert {e.kind for e in rec.events()} - \
        {e.kind for e in plain.tracer.events()} <= HOST_SPANS
    strip = [e.comparable()[1:] for e in rec.events()
             if e.kind not in HOST_SPANS]
    assert strip == [c[1:] for c in plain.tracer.comparable()]
    assert set(timed.metrics.counters) - set(plain.metrics.counters) == \
        GRAPH_COUNTERS
    assert {k: timed.metrics.counters[k] for k in plain.metrics.counters} \
        == dict(plain.metrics.counters)


def test_untimed_recorder_spans_nothing():
    rec = FlightRecorder()
    with rec.span("host.admit", rid=1) as span:
        assert span is None
    assert len(rec) == 0 and rec.device_events() is None
    rec.attach("cpu")
    assert ttracer._attached == 0
    assert ttracer.NULL_RECORDER.span("host.admit") is ttracer._NO_SPAN
    with pytest.raises(ValueError):
        FlightRecorder(timing=True).emit("host.nothing")


def test_perf_names_its_round_time_source(pair):
    arrivals = [(i * 3.0, p, 3) for i, p in enumerate(ts.prompts(pair[2],
                                                                 2))]
    _, sched = ts.serve(ts.PORT, pair[1], arrivals, perf=True,
                        use_fused=True, n_slots=2)
    perf = sched.executor.perf
    assert perf.summary()["round_ms_source"] == "host"
    assert sched.metrics.snapshot()["perf"]["round_ms_source"] == "host"
    perf.observe_round(sched.executor, 50.0, "fused", device_ms=2.0)
    s = perf.summary()
    assert s["round_ms_source"] == "device" and s["round_ms"] == 2.0
    assert s["roofline_utilization"] == pytest.approx(
        s["bound_step_us"] / 2e3)


def test_chrome_trace_draws_device_spans():
    rec = FlightRecorder(timing=True)
    rec.emit("round.harvest", track="rounds", t_ms=5.0, overlap=True,
             n_harvested=2, wall_dur_ms=9.0,
             wall_args={"block_ms": 1.0, "device_ms": 3.0,
                        "device_t_ms": 4.5})
    rec.emit("host.admit", track="host", t_ms=1.0, dur_ms=2.0, rid=0,
             prompt_len=8, wall_args={"device_ms": 1.5,
                                      "device_t_ms": 1.25})
    rec.emit("round.harvest", track="rounds", t_ms=9.0, overlap=True,
             n_harvested=2)                      # untimed: no slice
    trace = texport.chrome_trace(rec)
    dev = [e for e in trace["traceEvents"] if e.get("cat") == "device"]
    assert [(e["name"], e["ts"], e["dur"]) for e in dev] == [
        ("device.round", 4500.0, 3000.0), ("device.prefill", 1250.0, 1500.0)]
    stats = texport.validate_chrome_trace(trace)
    assert stats["n_device_spans"] == 2
    names = [e["args"]["name"] for e in trace["traceEvents"]
             if e["name"] == "thread_name"]
    assert names == ["rounds", "host", "device"]
