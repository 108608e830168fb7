"""Parity of the port's observability with the reference package's, on the
CPU at smoke size (``_torch_sched.make_pair``: one set of weights on both
sides).

  * ``obs.perf``: the round costs (reference and fused variants, useful
    FLOPs) within 5% of the reference's HLO-counted ones for the same
    config and mask (the reference's own band, test_obs_perf.py);
    ``parity_device_equiv`` flat in T; every kernel launch costed; a
    wrapper's torch ops never counted beside its report;
  * ``obs.spans`` / ``obs.slo``: a seeded chaos run gives the reference's
    span trees (deterministic fields) and the same SLO report text;
  * ``obs.export``: the Chrome trace validates (every injected erasure
    linked to its resolution, span trees closed) and rejects tampering;
  * ``RuntimeMetrics.snapshot()`` has the reference's keys, ``perf``
    among them (exposed as Prometheus gauges, also by the live
    ``MetricsServer`` on localhost), and the serving entry point prints
    the perf line, the SLO report and the trace line.
"""
import copy
import dataclasses
import json
import urllib.request

import numpy as np
import pytest
import torch

import _torch_sched as ts
from repro.obs.perf import attribute_round_costs as jattribute
from repro.obs.slo import decompositions as jdecompositions
from repro.obs.slo import render_report as jrender_report
from repro.runtime import metrics as jmetrics
from repro.runtime.executor import SlotPoolExecutor as JPool
from repro_torch.configs import get_arch, smoke_config
from repro_torch.kernels import accounting, cdc_matmul, ops
from repro_torch.launch import serve as tserve
from repro_torch.models import TPCtx, build
from repro_torch.obs import export as texport
from repro_torch.obs import perf as tperf
from repro_torch.obs.slo import decompositions, render_report
from repro_torch.runtime import metrics as tmetrics
from repro_torch.runtime.executor import SlotPoolExecutor
from repro_torch.serve import ModelStepper

CHAOS = dict(chaos={"spec": dict(mtbf_ms=60.0, mttr_ms=12.0,
                                 p_degraded=0.25), "seed": 11},
             latency={"base": dict(floor_ms=1.0, mu=0.0, sigma=0.5),
                      "seed": 11},
             n_slots=2, seed=11)


@pytest.fixture(scope="module")
def pair():
    return ts.make_pair()


@pytest.fixture(scope="module")
def costs(pair):
    """Both packages' round costs over a 2-slot executor's state."""
    jstepper, tstepper, _ = pair
    jex = JPool(jstepper, 2, use_fused=True)
    tex = SlotPoolExecutor(tstepper, 2, use_fused=True)
    return (jattribute(jex.vstep, jex.state, jex.last_toks),
            tperf.attribute_round_costs(tex.vstep, tex.state,
                                        tex.last_toks))


@pytest.fixture(scope="module")
def chaos_runs(pair):
    """A seeded, traced chaos run on each side."""
    jstepper, tstepper, cfg = pair
    arrivals = [(i * 3.0, p, ts.GEN) for i, p in
                enumerate(ts.prompts(cfg, 3))]
    want, jsched = ts.serve(ts.JAX, jstepper, arrivals, traced=True, **CHAOS)
    got, tsched = ts.serve(ts.PORT, tstepper, arrivals, traced=True,
                           **CHAOS)
    return want, jsched, got, tsched


@pytest.mark.parametrize("variant", ["reference", "fused"])
def test_round_flops_within_5pct_of_reference(costs, variant):
    jc, tc = costs
    want, got = jc[variant], tc[variant]
    gap = got.flops / want.flops - 1.0
    useful_gap = got.useful_flops / want.useful_flops - 1.0
    print(f"{variant}: port {got.flops:.0f} vs reference {want.flops:.0f} "
          f"FLOPs (gap {gap:+.4%}); useful {got.useful_flops:.0f} vs "
          f"{want.useful_flops:.0f} (gap {useful_gap:+.4%})")
    assert abs(gap) < 0.05
    assert abs(useful_gap) < 0.05
    assert got.T == want.T and got.r == want.r
    assert got.wire_bytes == 0.0 and got.bytes > 0
    assert got.dominant == "memory"


def test_every_launch_is_costed(costs):
    _, tc = costs
    assert set(tc) == {"reference", "fused"}
    assert all(c.custom_calls_uncosted == 0 for c in tc.values())
    # and a wrapper without a cost model does count as uncosted
    probe = accounting.costed("no_such_kernel")(lambda x: x + 1)
    probe.launches = 0
    try:
        counter = tperf.count_round(lambda: probe(torch.ones(4)))
    finally:
        accounting.WRAPPERS.pop("no_such_kernel")
    assert counter.custom_calls_uncosted == 1
    assert counter.kernels == {"no_such_kernel": 1}


def test_wrapper_counts_its_report_not_its_plain_version():
    """On the CPU a wrapper runs its plain version; only the cost it
    reports counts, so the CPU and the card give the same figures."""
    cfg = smoke_config(get_arch("granite-3-8b"))
    model = build(cfg, TPCtx(tp=4, mode="coded", code_r=2))
    params = model.encode_offline(model.init(0, device="cpu"))
    p = params["layers"]["ffn"]["w1"]
    w, wc = p["w"][0], p["cdc"][0]
    k, m = w.shape
    valid = np.ones(4, bool)
    esel, coef, gen = ops.decode_plan(model.ctx.spec, tuple(valid),
                                      tuple(valid), m // 4, "cpu")
    x = torch.randn(3, k)
    counter = tperf.count_round(lambda: cdc_matmul.cdc_coded_matmul(
        x, w, wc, "folded", 4, 2, gen, esel, coef, valid))
    assert counter.flops == 2.0 * 3 * k * (m // 4) * (4 + 2)
    assert counter.bytes == 4 * (x.numel() + w.numel() + wc.numel()
                                 + gen.numel() + esel.numel() + coef.numel()
                                 + 3 * m)
    assert counter.kernels == {"cdc_coded_matmul": 1}


def test_parity_device_equiv_flat_in_T():
    """Fig. 2 as a runtime metric: at r = 1 the parity work is ~1 shard's
    useful work whatever T is, while parity / total falls with T (8 heads
    so that T = 8 needs no padded heads)."""
    cfg = dataclasses.replace(smoke_config(get_arch("granite-3-8b")),
                              n_heads=8, n_kv_heads=8, head_dim=16)
    got = {}
    for t in (2, 4, 8):
        model = build(cfg, TPCtx(tp=t, mode="coded", code_r=1))
        stepper = ModelStepper(model, model.init(0, device="cpu"),
                               max_len=16)
        ex = SlotPoolExecutor(stepper, 2, use_fused=False)
        got[t] = tperf.attribute_round_costs(ex.vstep, ex.state,
                                             ex.last_toks)["reference"]
    pde = [got[t].parity_device_equiv for t in (2, 4, 8)]
    print("parity_device_equiv at T = 2, 4, 8:", pde)
    assert min(pde) > 0
    assert (max(pde) - min(pde)) / min(pde) < 0.10
    frac = [got[t].coded_overhead_frac for t in (2, 4, 8)]
    assert frac[0] > frac[1] > frac[2]


def test_span_trees_match_reference(chaos_runs):
    want, jsched, got, tsched = chaos_runs
    assert got["counters"] == want["counters"]
    assert got["counters"]["beyond_budget_failures"] > 0
    assert tsched.spans.comparable() == jsched.spans.comparable()
    assert tsched.spans.check_all_closed() == len(tsched.spans.terminal())
    assert tsched.spans.dropped == 0


def test_slo_report_matches_reference(chaos_runs):
    _, jsched, _, tsched = chaos_runs
    text = render_report(decompositions(tsched.spans))
    assert text == jrender_report(jdecompositions(jsched.spans))
    assert "fault_recovery" in text


def test_chrome_trace_validates_and_rejects_tampering(chaos_runs, tmp_path):
    _, _, _, tsched = chaos_runs
    path = tmp_path / "chaos.trace.json"
    texport.write_chrome_trace(path, tsched.tracer, tsched.shardlog,
                               now_ms=tsched.clock.now(),
                               spans=tsched.spans)
    trace = json.loads(path.read_text())
    stats = texport.validate_chrome_trace(trace, require_fault_links=True,
                                          require_span_closure=True)
    assert stats["n_linked"] == stats["n_injected_erasures"] > 0
    assert stats["dropped_events"] == 0
    assert stats["n_span_trees"] == 3
    # an injected erasure whose resolution is gone
    unlinked = copy.deepcopy(trace)
    unlinked["traceEvents"] = [
        e for e in unlinked["traceEvents"]
        if e["name"] not in ("fault.recovered", "fault.beyond_budget",
                             "fault.noop")]
    with pytest.raises(ValueError):
        texport.validate_chrome_trace(unlinked, require_fault_links=True)
    # a span tree with a gap: the first queue_wait ends 0.5 ms late
    gapped = copy.deepcopy(trace)
    end = next(e for e in gapped["traceEvents"]
               if e["name"] == "queue_wait" and e["ph"] == "e")
    end["ts"] += 500.0
    with pytest.raises(ValueError):
        texport.validate_chrome_trace(gapped, require_span_closure=True)


def test_snapshot_has_reference_keys_and_perf(pair):
    """A perf-enabled port run: the snapshot's keys are the reference's,
    ``perf`` carries the attribution and the achieved rates, and the
    Prometheus text exposes them; the perf cost rounds add no launch."""
    _, tstepper, cfg = pair
    arrivals = [(i * 3.0, p, 3) for i, p in enumerate(ts.prompts(cfg, 2))]
    launches = accounting.snapshot()
    _, sched = ts.serve(ts.PORT, tstepper, arrivals, perf=True,
                        use_fused=True, n_slots=2)
    assert accounting.snapshot() == launches
    snap = sched.metrics.snapshot()
    assert set(snap) == set(jmetrics.RuntimeMetrics().snapshot())
    perf = snap["perf"]
    assert perf["variant"] == "fused" and perf["custom_calls_uncosted"] == 0
    assert perf["n_rounds_observed"] == len(sched.executor.round_ms)
    assert 0 < perf["roofline_utilization"] < 1
    assert perf["model_flops"] > 0 and perf["hbm_bytes"] > 0
    assert sched.executor.perf.n_attributions == 1
    prom = texport.prometheus_text(sched.metrics, sched.shardlog)
    assert "repro_perf_roofline_utilization" in prom
    server = texport.MetricsServer(sched.metrics, sched.shardlog,
                                   sched.tracer, sched.clock, port=0,
                                   spans=sched.spans).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
            assert r.status == 200 and r.read() == b"ok\n"
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            assert "repro_perf_achieved_flops_per_s" in r.read().decode()
    finally:
        server.stop()
    blank = tmetrics.RuntimeMetrics()
    blank.set_perf({"round_ms": 1.0})
    assert blank.snapshot()["perf"] == {"round_ms": 1.0}


def test_serve_prints_perf_slo_and_trace(tmp_path, capsys):
    path = tmp_path / "t.json"
    tserve.main(["--smoke", "--coded", "--device", "cpu", "--requests", "3",
                 "--gen-tokens", "4", "--perf", "--slo-report", "--trace",
                 str(path)])
    out = capsys.readouterr().out
    assert "completed 3/3 requests" in out
    assert "round dispatches, 0 graph capture(s), 0 replay(s)" in out
    assert "perf: " in out and "0 uncosted" in out
    assert "--- slo report" in out and "ttft_ms" in out
    assert f"trace: wrote {path}" in out
    texport.validate_chrome_trace(json.loads(path.read_text()),
                                  require_perf_counters=True,
                                  require_span_closure=True)
