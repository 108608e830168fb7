"""The metric arithmetic, on hand-sized cases: tokens counted once across
a requeue, the tail over every gap, the two roofline counts, the model
FLOPs; and every metric, cell and configuration that BENCHMARK.json
names found as a file."""
import json
import re
import types

import numpy as np
import pytest

from harness import cells, costs, peaks, stats
from harness.ledger import Ledger
from repro_torch.runtime.request import Request, RequestState

BENCHMARK = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _req(rid, n_out=10):
    return Request(rid, np.arange(3), n_out)


def test_tokens_count_once_across_a_requeue():
    led, r = Ledger(), _req(0)
    led.track(r, 0.0)
    for t in range(1, 4):                   # tokens 0, 1, 2 at 1, 2, 3 ms
        r.tokens.append(7)
        led.observe(float(t))
    r.reset_for_requeue()                   # the 2MR half drops progress
    for t in range(4, 7):                   # regenerated 0..2: not new
        r.tokens.append(7)
        led.observe(float(t))
    r.tokens.append(7)                      # position 3, new at 10 ms
    led.observe(10.0)
    assert led.tokens_in(0, 100) == 4
    assert [p for _, _, p in led.deliveries] == [0, 1, 2, 3]
    assert led.gaps == [(2.0, 1.0), (3.0, 1.0), (10.0, 7.0)]
    assert led.deliveries[0] == (1.0, 0, 0)


def test_completion_is_seen_once():
    led, r = Ledger(), _req(1, n_out=1)
    led.track(r, 0.0)
    r.tokens.append(3)
    r.state = RequestState.COMPLETED
    assert led.observe(5.0) == [r]
    assert led.observe(6.0) == []
    assert led.tokens_in(0, 10) == 1


def test_p95_is_over_every_gap():
    gaps = list(range(1, 101))              # 100 gaps, one request each
    assert stats.percentile(gaps, 95) == pytest.approx(95.05)
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([], 95) is None


def test_prefill_busy_counts_what_each_prefill_launched():
    from harness import probes
    # (start, end, name, correlation id) in us; launches by id
    dev = [(0, 40, "round", 1), (45, 55, "mm", 2), (60, 90, "mm", 3),
           (300, 310, "mm", 4), (400, 420, "late", 9)]
    launch = {1: -10, 2: 20, 3: 30, 4: 250}
    # the round ran inside the first prefill but was launched before it;
    # event 9 has no launch on record and counts where it starts
    got = probes.launched_ms(dev, launch, [(200, 500), (10, 100)])
    assert got == pytest.approx([0.040, 0.030])


def test_control_is_judged_by_the_cell_limits():
    from harness import check
    spec = {"tokens": 1000, "limits": {"token_gap": 2e-4}}
    got = {"token_gap": 0.0, "mismatch_share": 0.0, "tokens": 1010,
           "control_gap": 7e-4, "control_mismatch_share": 0.002}
    assert check.passes(check.judge(spec, got))
    judged = check.judge(spec, check.as_program(got))
    assert judged["token_gap"] == {"value": 7e-4, "limit": 2e-4}
    assert not check.passes(judged)
    # too few tokens read is not correct either
    assert not check.passes(check.judge(spec, dict(got, tokens=999)))


def test_coded_gemm_counts_every_shard_product():
    # x [32, 4096] @ w [4096, 4096], T = 4, r = 2: parity 2 shards of 1024
    parity = 4096 * 2 * 1024
    flops, nbytes = costs.coded_gemm(32, 4096, 4096, parity)
    assert flops == 2 * 32 * 4096 * (4096 + 2048)
    assert nbytes == 4 * (32 * 4096 + 4096 * 4096 + parity + 32 * 4096)
    t = costs.least_seconds(flops, nbytes)
    assert t == max(flops / peaks.F32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)


def test_moe_counts_routed_experts_and_pairs_only():
    flops, nbytes = costs.moe_experts(16, 2048, 1408, 60, 4, experts_hit=40)
    assert flops == 2 * 16 * 2048 * 60 + 16 * 4 * 3 * 2 * 2048 * 1408
    assert nbytes == 4 * (40 * 3 * 2048 * 1408 + 2048 * 60 + 2 * 16 * 2048)
    # fewer experts hit, fewer bytes: a grouped product over the routed
    # experts reads its true share
    assert costs.moe_experts(16, 2048, 1408, 60, 4, 10)[1] < nbytes


def test_model_flops_from_widths():
    g = cells.config("granite-3-8b.t4r2.f32")
    d, f, v = 4096, 12800, 49155
    per_layer = d * 4096 + 2 * d * 1024 + 4096 * d + 3 * d * f
    assert costs.matmul_params(g) == 40 * per_layer + d * v
    q = cells.config("qwen2-moe-a2.7b.t4r2.f32")
    d = 2048
    per_layer = 4 * d * d + d * 60 + 4 * 3 * d * 1408 + 3 * d * 5632
    assert costs.matmul_params(q) == 24 * per_layer + d * 151936
    attn = 4 * 40 * 32 * 128
    assert costs.prefill_flops(g, 3) == \
        2 * costs.matmul_params(g) * 3 + attn * 6
    assert costs.decode_flops(g, 10) == 2 * costs.matmul_params(g) + attn * 10


def test_roofline_share_reads_none_without_calls():
    from harness import readers
    run = types.SimpleNamespace(ranges={"coded_gemm": {
        "device_s": 2.0, "least_s": 1.0, "calls": 3}})
    assert readers.roofline_pct(run, "coded_gemm") == 50.0
    assert readers.roofline_pct(run, "moe_experts") is None


def test_benchmark_names_its_files():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    for c in BENCHMARK["configs"]:
        assert NAME.match(c["name"])
        cfg = cells.config(c["name"])
        assert cfg["source"] == c["source"]
        assert c["file"] == f"bench/configs/{c['name']}.json"
        assert set(c["reduced"]) == set(cfg["published"])
        cells.module("reference", cfg["reference"])
    metrics = {m["name"]: m for m in BENCHMARK["end_to_end"]
               + BENCHMARK["per_layer"]}
    for name, m in metrics.items():
        assert NAME.match(name)
        assert cells.module("metrics", name).UNIT == m["unit"]
    for w in BENCHMARK["workloads"]:
        cell = cells.workload(w["name"])
        assert (cell["config"], cell["traffic"]) == (w["config"],
                                                     w["traffic"])
        cells.mix(w["traffic"])
        for name in cell["end_to_end"] + cell["per_layer"]:
            listed = metrics[name].get("workloads")
            assert listed is None or w["name"] in listed
        for name in cell["per_layer"]:
            assert metrics[name]["moves"] in cell["end_to_end"]
        assert "setup_s" in cell["end_to_end"]
    for name, m in metrics.items():
        for cell in m.get("workloads", []):
            w = cells.workload(cell)
            assert name in w["end_to_end"] + w["per_layer"]


def test_setup_bound_and_other_bounds():
    for m in BENCHMARK["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert [m["bound"] for m in BENCHMARK["end_to_end"]
            if m["name"] == "setup_s"] == [0.25]
