"""The port's chaos harness and adaptive redundancy planner against the
reference package's (smoke size, CPU).

Pure parts are held to the reference on the same seeds and inputs: the
injector's event lists, trace playback, ``parse_chaos``, the injected
latency series, the planner's decisions. The runtime parts run the same
workload through both schedulers and require equal completions, counters
and plan logs: batched == sequential under one fault schedule, in-budget
churn, ``set_code_r`` re-encoding and re-sizing the budget, the adaptive
planner raising r to 4 end to end, and ``apply_plan`` never shrinking
below the live dead shards. Last, the serving entry point with --chaos
prints the reference's completion and chaos lines.
"""
import sys

import numpy as np
import pytest
import torch

import _torch_sched as ts
from repro import faults as jf
from repro_torch import faults as tf

GEN = ts.GEN


@pytest.fixture(scope="module")
def coded():
    return ts.make_pair()


def _evs(evs):
    return [(e.time_ms, e.kind.value, e.shard) for e in evs]


SPECS = [dict(mtbf_ms=100, mttr_ms=20, p_permanent=0.1, p_degraded=0.2,
              groups=2, burst_mtbf_ms=300),
         dict(mtbf_ms=60, mttr_ms=10, fail_dist="weibull", weibull_k=1.3),
         dict(mtbf_ms=50, mttr_ms=10, p_permanent=1.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's smoke-size ops: the suite runs
    in several worker processes at once, and their thread pools would
    contend for the cores (4x slower here under that load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- injector ----

@pytest.mark.parametrize("spec", SPECS, ids=["mixed", "weibull", "perm"])
def test_injector_replay_equals_reference(spec):
    for seed in (0, 5):
        a = tf.FaultInjector(tf.ChaosSpec(**spec), 4, seed=seed)
        b = jf.FaultInjector(jf.ChaosSpec(**spec), 4, seed=seed)
        ea, eb = [], []
        for t in np.linspace(50.0, 900.0, 9):
            ea += a.events_until(float(t))
            eb += b.events_until(float(t))
            np.testing.assert_array_equal(a.slowdown_at(float(t)),
                                          b.slowdown_at(float(t)))
        assert _evs(ea) == _evs(eb) and ea
        assert a.degraded == b.degraded
        a.sync_replaced(np.ones(4, bool), 900.0)
        b.sync_replaced(np.ones(4, bool), 900.0)
        assert _evs(a.events_until(5000.0)) == _evs(b.events_until(5000.0))
    with pytest.raises(ValueError):
        a.events_until(10.0)


def test_traces_match_reference(tmp_path):
    rig = tf.make_pi_rig_trace(horizon_ms=1500.0, n_shards=12, seed=2)
    assert rig == jf.make_pi_rig_trace(horizon_ms=1500.0, n_shards=12,
                                       seed=2)
    churn = tf.churn_trace(4, 0.0, 1000.0, 100.0, 40.0, concurrent=2)
    assert churn == jf.churn_trace(4, 0.0, 1000.0, 100.0, 40.0,
                                   concurrent=2)
    path = tmp_path / "rig.jsonl"
    tf.write_trace(str(path), rig)
    assert tf.load_trace(str(path)) == rig
    a = tf.TraceInjector.from_file(str(path), 12)
    b = jf.TraceInjector(rig, 12)
    assert _evs(a.events_until(1500.0)) == _evs(b.events_until(1500.0))
    assert a.events_until(1500.0) == []
    np.testing.assert_array_equal(a.slowdown_at(700.0), b.slowdown_at(700.0))
    with pytest.raises(ValueError):
        tf.TraceInjector(rig, 4)
    with pytest.raises(ValueError):
        tf.churn_trace(4, 0.0, 100.0, period_ms=50.0, down_ms=60.0)


def test_parse_chaos(tmp_path):
    arg = "weibull:mtbf=300,mttr=40,p_perm=0.05,groups=2,burst_mtbf=500"
    inj = tf.parse_chaos(arg, 4, seed=1)
    assert isinstance(inj, tf.FaultInjector)
    assert inj.spec.__dict__ == jf.parse_chaos(arg, 4, seed=1).spec.__dict__
    assert _evs(inj.events_until(2000.0)) == \
        _evs(jf.parse_chaos(arg, 4, seed=1).events_until(2000.0))
    path = tmp_path / "t.jsonl"
    tf.write_trace(str(path), tf.churn_trace(4, 0.0, 100.0, 50.0, 20.0))
    assert isinstance(tf.parse_chaos(str(path), 4), tf.TraceInjector)
    for bad in ("exp:bogus=1", "gauss:mtbf=10"):
        with pytest.raises(ValueError):
            tf.parse_chaos(bad, 4)


@pytest.mark.parametrize("r", [0, 2])
def test_injected_latency_series_equals_reference(r):
    """round_ms and last_stall_ms over one churn schedule, mask included,
    equal the reference's draw for draw; the stall hook sleeps."""
    spec = dict(mtbf_ms=80.0, mttr_ms=30.0, p_degraded=0.3)
    series = []
    for mod in (tf, jf):
        inj = mod.FaultInjector(mod.ChaosSpec(**spec), 4, seed=3)
        lat = mod.InjectedLatency(mod.LatencySpec(timeout_ms=400.0), inj,
                                  seed=3)
        mask, out = np.ones(4, bool), []
        for t in np.arange(0.0, 600.0, 20.0):
            for ev in inj.events_until(float(t)):
                mask[ev.shard] = ev.kind.value == "recovery"
            out.append((lat.round_ms(float(t), 4, r, mask=mask.copy()),
                        lat.last_stall_ms))
        series.append(out)
        if mod is tf:
            mod.measured_stall_hook(lat, wall_scale=1e-6)(None, mask)
    assert series[0] == series[1]


# ------------------------------------------------------------ planner ----

def _plans(mod, cfg, windows, suitable=True, layout="folded"):
    p = mod.AdaptiveRedundancyPlanner(mod.PlannerConfig(**cfg),
                                      len(windows[0]), layout=layout,
                                      suitable=suitable)
    out = []
    for w, mask in enumerate(windows):
        for t in range(11):
            p.observe_round(20.0 * w + t, np.asarray(mask))
        plan = p.maybe_plan(20.0 * w + 11.0)
        out.append(None if plan is None else plan.as_dict())
        assert p.maybe_plan(20.0 * w + 11.5) is None
    return out


@pytest.mark.parametrize("layout,suitable", [("folded", True),
                                             ("dedicated", True),
                                             ("folded", False)])
def test_planner_decisions_equal_reference(layout, suitable):
    """Raise on a storm, hold through one calm window, lower after the
    cooldown; the Table-1 gate routes an unsuitable split to 2MR."""
    two, one, calm = [0, 0, 1, 1], [1, 0, 1, 1], [1, 1, 1, 1]
    windows = [two, calm, calm, one, calm, calm, calm]
    cfg = dict(window_ms=10.0, min_budget=1, max_budget=2, ewma=1.0,
               cooldown_windows=2)
    got = _plans(tf, cfg, windows, suitable, layout)
    assert got == _plans(jf, cfg, windows, suitable, layout)
    budgets = [p["budget"] for p in got]
    assert budgets[:3] == [2, 2, 1], budgets
    if suitable:
        assert got[0]["r"] == (4 if layout == "folded" else 2)
    else:
        assert got[0]["r"] == 0 and got[0]["standby_replicas"] == 2


def test_planner_at_t8_folded_plans_r4():
    """At T=8 folded the default cap (max_budget=2) plans r = 2 x 2 = 4
    on a 2-dead storm, as the reference does: kernel 1 has a (8, 4) case
    for that round (and (8, 3) beside it)."""
    storm = [True] * 8
    storm[2] = storm[5] = False
    windows = [storm, [True] * 8, [True] * 8]
    cfg = dict(window_ms=10.0, ewma=1.0)
    got = _plans(tf, cfg, windows)
    assert got == _plans(jf, cfg, windows)
    assert tf.PlannerConfig().max_budget == 2
    assert got[0]["budget"] == 2 and got[0]["r"] == 4


def test_binomial_tail_and_required_budget():
    for n, p, b in ((4, 0.0, 0), (4, 1.0, 3), (4, 1.0, 4), (2, 0.1, 0),
                    (8, 0.3, 2)):
        assert tf.binomial_tail(n, p, b) == jf.binomial_tail(n, p, b)
    for args in ((4, 0.0, 0.999, 4), (4, 0.001, 0.999, 4),
                 (4, 0.9, 0.999999, 2)):
        assert tf.required_budget(*args) == jf.required_budget(*args)
    with pytest.raises(ValueError):
        tf.PlannerConfig(window_ms=0.0)


# ----------------------------------------------- runtime under chaos ----

def _staggered(cfg, n, gap):
    return [(i * gap, p, GEN) for i, p in enumerate(ts.prompts(cfg, n))]


@pytest.mark.parametrize("batched", [True, False],
                         ids=["batched", "sequential"])
def test_identical_fault_schedule_batched_and_sequential(coded, batched):
    """One churn schedule: each executor of the port equals the
    reference's batched run token for token; both recover in-step."""
    _, _, cfg = coded
    arrivals = _staggered(cfg, 4, 1.5)
    chaos = {"trace": tf.churn_trace(4, 2.0, 40.0, period_ms=8.0,
                                     down_ms=3.0)}
    want, got, _ = ts.both(coded, arrivals, chaos=chaos, n_slots=2,
                           batched=batched)
    assert got["counters"] == want["counters"]
    assert got["done"] == want["done"] and len(got["done"]) == 4
    assert got["counters"]["erasures_recovered"] > 0
    assert got["counters"]["beyond_budget_failures"] == 0


def test_in_budget_chaos_loses_nothing_and_tokens_match(coded):
    _, tstepper, cfg = coded
    arrivals = _staggered(cfg, 4, 2.0)
    base, _ = ts.serve(ts.PORT, tstepper, arrivals, n_slots=2)
    chaos = {"trace": tf.churn_trace(4, 1.0, 60.0, period_ms=10.0,
                                     down_ms=4.0)}
    want, got, _ = ts.both(coded, arrivals, chaos=chaos, n_slots=2)
    assert got == want
    assert got["done"] == base["done"]
    c = got["counters"]
    assert c["requests_completed"] == 4 and c["erasures_recovered"] > 0
    assert c["beyond_budget_failures"] == 0


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_set_code_r_reencodes_and_resizes_budget():
    """r 2 -> 4 on both packages: equal parity leaves (1e-5), budget 2, a
    no-op at the same geometry, then two concurrent erasures recovered
    in-step with equal tokens and counters."""
    jstepper, tstepper, cfg = ts.make_pair(code_r=2)
    old = tstepper.params["lm_head"]["cdc"].shape
    assert jstepper.set_code_r(4) and tstepper.set_code_r(4)
    assert tstepper.erasure_budget == jstepper.erasure_budget == 2
    assert tstepper.params["lm_head"]["cdc"].shape != old
    assert tstepper.last_reencode_wall_ms > 0.0
    assert not tstepper.set_code_r(4)
    jl = dict(_leaves(jstepper.params))
    n = 0
    for path, leaf in _leaves(tstepper.params):
        if path[-1] == "cdc":
            np.testing.assert_allclose(leaf.numpy(), np.asarray(jl[path]),
                                       rtol=1e-5, atol=1e-5)
            n += 1
    assert n == 6
    rng = np.random.default_rng(3)
    arrivals = [(0.0, rng.integers(0, cfg.vocab, ts.PROMPT_LEN), GEN)]
    want, got, sched = ts.both(
        (jstepper, tstepper, cfg), arrivals, n_slots=1,
        events=[("erasure", 1.0, 0), ("erasure", 1.5, 3)])
    assert got == want
    assert len(got["done"]) == 1 and len(got["done"][0][1]) == GEN
    assert got["counters"]["beyond_budget_failures"] == 0
    assert got["counters"]["erasures_recovered"] == 2


def test_set_code_r_records_trace_events():
    from repro_torch.obs import FlightRecorder
    _, tstepper, _ = ts.make_pair(code_r=2)
    tracer = FlightRecorder()
    tstepper.tracer = tracer
    assert tstepper.set_code_r(4)
    (ev,) = tracer.by_kind("code.resize")
    assert ev.args == {"r_old": 2, "r_new": 4, "budget": 2}
    with pytest.raises(ValueError):
        tracer.emit("code.resized")


def test_adaptive_planner_raises_and_lowers_r_end_to_end():
    """Calm -> storm (2 concurrent dead > budget) -> calm on both
    packages: equal completions, counters and plan logs; r rises to 4,
    the storm then recovers in-step, and r comes back down."""
    pair = ts.make_pair(code_r=2)
    _, tstepper, cfg = pair
    rng = np.random.default_rng(5)
    arrivals = [(i * 10.0, rng.integers(0, cfg.vocab, ts.PROMPT_LEN), GEN)
                for i in range(14)]
    chaos = {"trace": tf.churn_trace(4, 20.0, 80.0, period_ms=8.0,
                                     down_ms=3.0, concurrent=2)}
    want, got, sched = ts.both(
        pair, arrivals, chaos=chaos, n_slots=2,
        planner=dict(window_ms=10.0, min_budget=1, max_budget=2,
                     cooldown_windows=2))
    assert got == want
    rs = [r for _, r in got["snapshot"]["planner"]["r_series"]]
    assert len(got["done"]) == 14
    assert max(rs) == 4 and rs[0] == 2 and rs[-1] == 2, rs
    c = got["counters"]
    assert c["replans"] >= 2 and c["erasures_recovered"] > 0
    assert sched.health.budget == tstepper.erasure_budget


def test_apply_plan_never_shrinks_below_live_dead_shards():
    out = []
    for side, stepper in zip((ts.JAX, ts.PORT), ts.make_pair(code_r=4)):
        sched = side.rt.ContinuousBatchingScheduler(
            stepper, side.rt.RuntimeConfig(n_slots=1))
        sched.health.set_budget(stepper.erasure_budget)
        sched.health.apply(side.rt.erasure(0.0, 0))
        sched.health.apply(side.rt.erasure(0.5, 1))
        plan = side.faults.RedundancyPlan(
            t_ms=1.0, budget=1, r=2, standby_replicas=1,
            est_unavailability=0.0, window_max_dead=0, reason="test")
        out.append((side.faults.apply_plan(sched, plan),
                    stepper.erasure_budget, int(stepper.model.ctx.code_r),
                    dict(sched.metrics.counters)))
    assert out[1] == out[0]
    assert out[1][1] >= 2 and out[1][2] == 4


# ------------------------------------------------- the serving driver ----

CHAOS_ARGV = ["--smoke", "--coded", "--chaos", "exp:mtbf=800,mttr=120",
              "--seed", "0"]


def _lines(text: str) -> dict:
    keys = ("completed ", "chaos: ")
    return {k: next(line for line in text.splitlines()
                    if line.startswith(k)) for k in keys}


def test_serve_chaos_cli_matches_reference(capsys, monkeypatch):
    """``launch.serve`` on the CPU with --chaos prints the reference's
    completion and chaos lines, and the same counters, at the same seed
    (the weights differ: each package draws its own)."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    sched = tserve.main(CHAOS_ARGV + ["--device", "cpu"])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + CHAOS_ARGV)
    jserve.main()
    want = capsys.readouterr().out
    assert _lines(got) == _lines(want)
    counters = sched.metrics.counters
    assert f'"beyond_budget_failures": ' \
           f'{counters["beyond_budget_failures"]}' in want
    assert counters["faults_injected"] > 0
    assert sched.stepper.device.type == "cpu"


def test_serve_scheduler_needs_a_device_flag_without_cuda(monkeypatch):
    from repro_torch.launch import serve as tserve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(CHAOS_ARGV)


def test_traced_chaos_run_records_the_reference_event_stream(coded):
    """With a flight recorder attached, a chaos run with a 2MR requeue and
    re-encodes records the reference's event stream: the same kinds,
    tracks, simulated stamps and arguments in the same order (wall-clock
    fields excluded, as the reference's replay comparison does)."""
    jstepper, tstepper, cfg = coded
    arrivals = _staggered(cfg, 3, 1.5)
    chaos = {"trace": [{"t_ms": 2.0, "kind": "erasure", "shard": 1},
                       {"t_ms": 3.0, "kind": "erasure", "shard": 2},
                       {"t_ms": 6.0, "kind": "erasure", "shard": 0},
                       {"t_ms": 8.0, "kind": "recovery", "shard": 0}]}
    streams = []
    for side, stepper in ((ts.JAX, jstepper), (ts.PORT, tstepper)):
        untraced = stepper.tracer     # the scheduler adopts the stepper
        sched = ts.build_sched(side, stepper, chaos=chaos, n_slots=2,
                               traced=True)
        side.rt.run_arrivals(sched, arrivals)
        stepper.tracer = untraced
        streams.append(sched.tracer.comparable())
    want, got = streams
    assert got == want
    kinds = {e[1] for e in got}
    assert {"fault.inject", "fault.recovered", "fault.beyond_budget",
            "request.requeue", "shard.heal_all", "code.reencode",
            "round.dispatch", "round.harvest"} <= kinds
