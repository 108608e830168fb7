"""The port's continuous-batching scheduler against the reference package's
(smoke size, CPU, SimClock).

Every scenario runs the same workload through both packages on the same
weights and requires equal completions (rid order and tokens), equal
counters and an equal simulated-clock snapshot, then checks the property
the reference's own test (tests/test_runtime.py) pins: FIFO admission and
slot reuse, no request lost across a mid-decode erasure (CDC path),
requeue + heal beyond the budget (2MR path), heal + re-encode on
recovery, chaos replay from one root seed, counters that add up, and the
idle gap fast-forward. The host-only modules (health controller, queue,
clock, metrics, seeds, policy, failure models) are held to theirs on the
same inputs.
"""
import numpy as np
import pytest

import _torch_sched as ts
from repro.core import failure as jfailure
from repro.core import policy as jpolicy
from repro.core import seeds as jseeds
from repro.runtime import metrics as jmetrics
from repro.runtime import queue as jqueue
from repro.runtime import request as jrequest
from repro_torch.core import failure as tfailure
from repro_torch.core import policy as tpolicy
from repro_torch.core import seeds as tseeds
from repro_torch.runtime import metrics as tmetrics
from repro_torch.runtime import queue as tqueue
from repro_torch.runtime import request as trequest

GEN = ts.GEN


@pytest.fixture(scope="module")
def coded():
    return ts.make_pair()


@pytest.fixture(scope="module")
def uncoded():
    return ts.make_pair(coded=False)


def _same(want, got):
    assert got["done"] == want["done"]
    assert got["counters"] == want["counters"]
    assert got["snapshot"] == want["snapshot"]
    assert got["n_measured"] == want["n_measured"] > 0
    assert got["shed"] == want["shed"] and got["mask"] == want["mask"]


def _at_zero(prompts):
    return [(0.0, p, GEN) for p in prompts]


# ------------------------------------------------- scheduler semantics ----

def test_fifo_admission_and_slot_reuse(coded):
    jstepper, tstepper, cfg = coded
    results = []
    for side, stepper in ((ts.JAX, jstepper), (ts.PORT, tstepper)):
        sched = ts.build_sched(side, stepper, n_slots=2)
        reqs = [sched.submit(p, GEN) for p in ts.prompts(cfg, 5)]
        done = sched.run()
        results.append((ts.outcome(sched, done), sched, reqs))
    (want, _, _), (got, sched, reqs) = results
    _same(want, got)
    assert len(got["done"]) == 5 and not sched.busy
    admits = sorted(reqs, key=lambda r: (r.admitted_ms, r.rid))
    assert [r.rid for r in admits] == [0, 1, 2, 3, 4]
    assert sum(s.occupancies for s in sched.slots) == 5
    assert max(s.occupancies for s in sched.slots) >= 2
    assert reqs[0].queueing_ms == 0.0 and reqs[4].queueing_ms > 0.0


@pytest.mark.parametrize("batched", [True, False],
                         ids=["batched", "sequential"])
@pytest.mark.parametrize("mode", ["coded", "uncoded"])
def test_mid_decode_erasure_loses_no_request(request, mode, batched):
    """Shard 1 dies at 2 ms, while both slots decode. Coded: recovered
    in-step, tokens equal to the fault-free stream, nothing requeued.
    Uncoded (budget 0): the 2MR path requeues, heals and re-encodes, and
    every request still completes."""
    pair = request.getfixturevalue(mode)
    _, tstepper, cfg = pair
    arrivals = _at_zero(ts.prompts(cfg, 4))
    want, got, _ = ts.both(pair, arrivals, events=[("erasure", 2.0, 1)],
                           n_slots=2, batched=batched)
    _same(want, got)
    clean, _ = ts.serve(ts.PORT, tstepper, arrivals, n_slots=2,
                        batched=batched)
    assert got["done"] == clean["done"] and len(got["done"]) == 4
    c = got["counters"]
    if mode == "coded":
        assert c["erasures_recovered"] == 1
        assert c["requests_requeued"] == c["beyond_budget_failures"] == 0
    else:
        assert c["erasures_recovered"] == 0
        assert c["beyond_budget_failures"] == 1
        assert c["requests_requeued"] >= 1 and c["parity_reencodes"] == 1
        assert got["mask"] == [True] * ts.T


def test_fused_round_matches_reference_scheduler(coded):
    """The port's fused round (the kernels' plain versions on the CPU)
    under the same erasure gives the reference scheduler's tokens."""
    _, _, cfg = coded
    want, got, sched = ts.both(coded, _at_zero(ts.prompts(cfg, 4)),
                               events=[("erasure", 2.0, 1)], n_slots=2,
                               use_fused=True)
    _same(want, got)
    assert sched.executor.vstep.use_fused
    assert sched.executor.vstep.last_variant == "fused"


def test_requeue_on_beyond_budget_failure(coded):
    _, tstepper, cfg = coded
    assert tstepper.erasure_budget == 1
    want, got, sched = ts.both(
        coded, _at_zero(ts.prompts(cfg, 4)), n_slots=2,
        events=[("erasure", 2.0, 1), ("erasure", 3.0, 2)])
    _same(want, got)
    c = got["counters"]
    assert c["requests_completed"] == c["requests_submitted"] == 4
    assert c["erasures_recovered"] == 1 and c["beyond_budget_failures"] == 1
    assert c["requests_requeued"] >= 1 and c["parity_reencodes"] >= 1
    assert sched.health.mask.all()
    assert max(r.n_requeues for r in sched.completed) == 1


def test_recovery_event_heals_and_reencodes(coded):
    _, _, cfg = coded
    want, got, sched = ts.both(
        coded, _at_zero(ts.prompts(cfg, 2)), n_slots=2,
        events=[("erasure", 2.0, 1), ("recovery", 4.0, 1)])
    _same(want, got)
    c = got["counters"]
    assert c["erasures_recovered"] == c["shards_healed"] == 1
    assert c["parity_reencodes"] == 1
    assert sched.shardlog.reencodes == 1
    assert sched.stepper.last_reencode_wall_ms > 0.0


def test_deterministic_chaos_repeatability(coded):
    """One root seed threads the stragglers, the injector and the
    injected latency: the port replays bit-exact and equals the
    reference on the same seed."""
    _, tstepper, cfg = coded
    arrivals = [(i * 3.0, p, GEN) for i, p in enumerate(ts.prompts(cfg, 3))]
    kw = dict(chaos={"spec": dict(mtbf_ms=60.0, mttr_ms=12.0,
                                  p_degraded=0.25), "seed": 11},
              latency={"base": dict(floor_ms=1.0, mu=0.0, sigma=0.5),
                       "seed": 11},
              n_slots=2, seed=11)
    want, got, _ = ts.both(coded, arrivals, **kw)
    again, _ = ts.serve(ts.PORT, tstepper, arrivals, **kw)
    _same(want, got)
    _same(got, again)
    assert got["counters"]["faults_injected"] > 0


def test_metrics_counters_add_up(coded):
    _, _, cfg = coded
    n = 4
    want, got, sched = ts.both(coded, _at_zero(ts.prompts(cfg, n)),
                               n_slots=2)
    _same(want, got)
    c, snap = got["counters"], got["snapshot"]
    assert c["tokens_generated"] == n * GEN == sum(
        len(t) for _, t in got["done"])
    assert c["requests_admitted"] == c["requests_completed"] == n
    assert snap["request_latency"]["n"] == n
    assert snap["throughput"]["tokens_per_s"] > 0
    assert snap["queue_depth"]["max"] >= 2
    assert snap["elapsed_ms"] == pytest.approx(
        c["decode_rounds"] * sched.rcfg.step_time_ms)


def test_idle_gap_fast_forwards_clock(coded):
    _, _, cfg = coded
    p = ts.prompts(cfg, 2)
    want, got, sched = ts.both(coded, [(0.0, p[0], 2), (500.0, p[1], 2)],
                               n_slots=2)
    _same(want, got)
    assert sched.clock.now() >= 500.0
    assert got["counters"]["requests_completed"] == 2


def test_deadline_queue_sheds_like_reference(coded):
    """Deadlines bend the admission order and a depth bound sheds the
    worst-ordered request, as the serving driver's --deadline-ms and
    --max-queue-depth do."""
    jstepper, tstepper, cfg = coded
    outs = []
    for side, stepper in ((ts.JAX, jstepper), (ts.PORT, tstepper)):
        sched = ts.build_sched(side, stepper, n_slots=2, max_queue_depth=2)
        for i, p in enumerate(ts.prompts(cfg, 6)):
            sched.submit(p, 3, deadline_ms=20.0 - 3.0 * i)
        outs.append(ts.outcome(sched, sched.run()))
    _same(*outs)
    assert outs[1]["counters"]["requests_shed"] > 0
    assert outs[1]["snapshot"]["shed_causes"]


def test_runtime_config_validation():
    from repro_torch.runtime import RuntimeConfig
    for bad in (dict(n_slots=0), dict(step_time_ms=-1.0),
                dict(max_queue_depth=0), dict(max_rounds=0)):
        with pytest.raises(ValueError):
            RuntimeConfig(**bad)


# --------------------------------------------- host-only modules (pure) ----

def _apply_all(side, n, budget, events):
    h = side.rt.ShardHealthController(n, budget=budget)
    acts = []
    for kind, t, shard in events:
        acts.append(h.apply(ts._event(side, kind, t, shard)).value)
        if acts[-1] == "requeue":
            acts.append(h.replace_replica(t))
    return acts, h.mask.tolist(), h.peak_dead


@pytest.mark.parametrize("budget", [0, 1, 2])
def test_health_controller_matches_reference(budget):
    rng = np.random.default_rng(budget)
    events = [(("erasure", "recovery", "replica_failure")[int(k)], float(t),
               int(s)) for k, t, s in zip(rng.integers(0, 3, 40),
                                          np.arange(40.0),
                                          rng.integers(0, 4, 40))]
    assert _apply_all(ts.PORT, 4, budget, events) == \
        _apply_all(ts.JAX, 4, budget, events)


def test_health_poll_order_budget_gate_and_duplicates():
    from repro_torch.core.policy import INPUT_SPLIT
    from repro_torch.runtime import (HealthAction, ShardHealthController,
                                     erasure, recovery)
    h = ShardHealthController(4, budget=2, events=[erasure(5.0, 1),
                                                   erasure(1.0, 0)])
    assert h.poll(0.5) == []
    assert h.poll(10.0) == [HealthAction.CONTINUE] * 2
    assert [ev.shard for ev, _ in h.log] == [0, 1]
    assert ShardHealthController(4, 2, split=INPUT_SPLIT).budget == 0
    d = ShardHealthController(4, budget=1)
    assert d.apply(erasure(0.0, 1)) is HealthAction.CONTINUE
    assert d.apply(erasure(1.0, 1)) is HealthAction.NOOP
    assert d.apply(recovery(2.0, 1)) is HealthAction.REENCODE
    assert d.apply(recovery(3.0, 1)) is HealthAction.NOOP
    with pytest.raises(ValueError):
        d.apply(erasure(0.0, 5))


def test_admission_queue_order_and_shedding_match_reference():
    rng = np.random.default_rng(3)
    spec = [(int(rng.integers(0, 2)), float(rng.integers(0, 50)),
             float(rng.integers(0, 10)), int(rng.integers(0, 2)))
            for _ in range(30)]

    def drive(qmod, rmod):
        q = qmod.AdmissionQueue(max_depth=5)
        log = []
        for rid, (prio, deadline, arrival, requeued) in enumerate(spec):
            req = rmod.Request(rid, np.array([1]), 1, arrival_ms=arrival,
                               deadline_ms=deadline or None, priority=prio,
                               n_requeues=requeued)
            victim = q.push(req)
            log.append(None if victim is None
                       else (victim.rid, victim.shed_reason))
        return log, [q.pop().rid for _ in range(len(q))]

    assert drive(tqueue, trequest) == drive(jqueue, jrequest)


def test_request_lifecycle():
    req = trequest.Request(0, np.array([1, 2]), 2, arrival_ms=1.0)
    req.admitted_ms, req.first_token_ms = 3.0, 4.0
    req.tokens = [5]
    req.reset_for_requeue()
    assert (req.state, req.tokens, req.first_token_ms, req.n_requeues) == \
        (trequest.RequestState.QUEUED, [], None, 1)
    with pytest.raises(ValueError):
        trequest.Request(1, np.array([]), 1)


def test_sim_clock():
    from repro_torch.runtime import SimClock, WallClock
    c = SimClock()
    c.advance(2.5)
    c.advance_to(2.0)
    assert c.now() == 2.5
    with pytest.raises(ValueError):
        c.advance(-1.0)
    assert WallClock().now() >= 0.0


def test_metrics_snapshot_matches_reference():
    rng = np.random.default_rng(4)
    vals = rng.lognormal(1.0, 1.0, size=(200, 4))
    snaps = []
    for mod in (jmetrics, tmetrics):
        m = mod.RuntimeMetrics(reservoir_size=64)
        for i, (a, b, c, d) in enumerate(vals):
            m.mark(float(i))
            m.count("decode_rounds")
            m.observe_request(a, b, ttft_ms=c)
            m.observe_round_ms(d)
            m.sample_queue_depth(float(i), i % 7)
            if i % 50 == 0:
                m.count_shed("queue_full")
                m.observe_plan({"t_ms": float(i), "r": 2 + i % 3}, True)
        with pytest.raises(KeyError):
            m.count("requests_complete")
        s = m.snapshot()
        s.pop("perf", None)
        snaps.append(s)
    assert snaps[1] == snaps[0]
    h = tmetrics.Histogram(reservoir_size=8)
    for x in range(20):
        h.observe(float(x))
    assert list(h.buckets())[-1] == (float("inf"), 20)


@pytest.mark.parametrize("name", ["straggler", "injector", "latency"])
def test_stream_seeds_bit_exact(name):
    for root in (0, 7, 2 ** 40 + 3):
        assert tseeds.stream_rng(root, name).random(8).tolist() == \
            jseeds.stream_rng(root, name).random(8).tolist()


def test_policy_table1_matches_reference():
    assert tpolicy.suitability_table() == jpolicy.suitability_table()
    assert {m.name: m.suitable_for_cdc for m in tpolicy.ALL_METHODS} == \
        tpolicy.TABLE_1


def test_failure_models_match_reference():
    model_t, model_j = tfailure.StragglerModel(), jfailure.StragglerModel()
    assert tfailure.mitigation_improvement(model_t, 4, 2, 2000, seed=1) == \
        jfailure.mitigation_improvement(model_j, 4, 2, 2000, seed=1)
    for args in ((np.random.default_rng(2), 8, 0.4, 2),
                 (np.random.default_rng(2), 8, 0.9, 8)):
        np.testing.assert_array_equal(
            tfailure.sample_erasures(*args),
            jfailure.sample_erasures(np.random.default_rng(2), *args[1:]))
    assert tfailure.coverage_2mr(8, 3) == jfailure.coverage_2mr(8, 3)
    assert tfailure.coverage_at_budget([4, 2], 3, 2) == \
        jfailure.coverage_at_budget([4, 2], 3, 2)
