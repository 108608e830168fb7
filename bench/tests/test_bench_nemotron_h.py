"""The nemotron-h-47b cell's pieces on the CPU: its configuration against
the port's registration and the catalog's published keys; the plain
reference against the port's coded forward at a small size, on the
weights the benchmark makes; a whole run of the cell at smoke size; the
mix; and the two readers of the Mamba-2 mixer (on hand-made spans and
events) with the bytes of ``roofline_pct.mamba2_step``."""
import copy
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import bench_smoke
from harness import cells, costs, mamba2_costs, peaks, probes, weights
from harness.run import Run
from repro_torch.obs.tracer import FlightRecorder

CONFIG = "nemotron-h-47b.l19.t4r2.f32"
CELL = "nemotron-h-47b.sharegpt32"
# the Mamba-2 widths a small configuration runs at (the file's keys)
SMALL_MAMBA = dict(mamba_num_heads=8, mamba_head_dim=16, n_groups=2,
                   ssm_state_size=16, chunk_size=16)


def small_config() -> dict:
    """The real configuration at the smoke widths (all 19 layers of its
    pattern: 9 Mamba-2, 9 MLP, 1 attention)."""
    cfg = dict(cells.config(CONFIG), **bench_smoke.SMALL, **SMALL_MAMBA)
    cfg.update(num_hidden_layers=19, num_key_value_heads=2,
               intermediate_size=256)
    return cfg


def port_arch(cfg: dict, _port_arch=cells.port_arch):
    """``cells.port_arch`` with the file's Mamba-2 widths (the registered
    ones are the published widths, which ``port_arch`` keeps)."""
    arch = _port_arch(cfg)
    return dataclasses.replace(
        arch, mamba_heads=cfg["mamba_num_heads"],
        mamba_head_dim=cfg["mamba_head_dim"], mamba_groups=cfg["n_groups"],
        ssm_state=cfg["ssm_state_size"], mamba_chunk=cfg["chunk_size"])


def _catalog_keys() -> dict:
    """The published keys as the configuration file holds them under
    ``published`` or as run (what is not in ``reduced`` is unchanged)."""
    cfg = cells.config(CONFIG)
    return {**cfg, **cfg["published"]}


def test_configuration_is_the_port_s_registration_cut_in_depth():
    cfg = cells.config(CONFIG)
    arch = cells.port_arch(cfg)
    pub = _catalog_keys()
    assert (arch.n_layers, arch.layer_kinds) == \
        (19, cfg["hybrid_override_pattern"])
    assert pub["hybrid_override_pattern"].startswith(arch.layer_kinds)
    assert len(pub["hybrid_override_pattern"]) == pub["num_hidden_layers"]
    assert (arch.mamba_heads, arch.mamba_head_dim, arch.mamba_groups,
            arch.ssm_state, arch.mamba_chunk, arch.conv_kernel) == \
        (pub["mamba_num_heads"], pub["mamba_head_dim"], pub["n_groups"],
         pub["ssm_state_size"], pub["chunk_size"], pub["conv_kernel"])
    assert arch.mamba_inner == pub["expand"] * pub["hidden_size"]
    assert (arch.d_model, arch.n_heads, arch.n_kv_heads, arch.hd,
            arch.d_ff, arch.vocab) == (
        pub["hidden_size"], pub["num_attention_heads"],
        pub["num_key_value_heads"], pub["attention_head_dim"],
        pub["intermediate_size"], pub["vocab_size"])
    assert arch.act == pub["mlp_hidden_act"] and not arch.rope
    assert arch.norm_eps == pub["rms_norm_eps"] == pub["layer_norm_epsilon"]
    assert pub["time_step_limit"] == [0, None]      # nothing clamped
    assert cfg["reference"] == "nemotron_h" and not cfg["tf32"]


@pytest.mark.parametrize("dead", [(), (2,)])
def test_reference_matches_the_port(dead):
    """The reference (the recurrence one position at a time) against the
    port's coded forward (the chunked SSD, chunks of 16 over 40 tokens),
    fault-free and with one shard lost, within 1e-4 (float32 summed in
    other orders through 19 layers; logits up to ~5)."""
    from repro_torch.models import TPCtx, build
    cfg = small_config()
    code = cfg["code"]
    model = build(port_arch(cfg), TPCtx(tp=code["T"], mode="coded",
                                        code_r=code["r"],
                                        code_layout=code["layout"]))
    params, _ = weights.make(model, 2 ** 33 + 7, torch.device("cpu"),
                             cfg["vocab_size"])
    coded = model.encode_offline(params)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg["vocab_size"], 40))
    valid = torch.ones(code["T"], dtype=torch.bool)
    valid[list(dead)] = False
    with torch.no_grad():
        port = model.forward(coded, {"tokens": tokens[None]}, valid)[0]
    ref = cells.module("reference", "nemotron_h").forward(cfg, params,
                                                          tokens)
    assert ref.shape == (40, cfg["vocab_size"])
    torch.testing.assert_close(port, ref, rtol=1e-4, atol=1e-4)


def test_weights_of_every_mamba2_leaf_and_the_state_they_keep():
    """``weights.make`` (no edit of its ``_scale``) on every Mamba-2 leaf:
    gains near 1, conv taps of 1 / sqrt(K), the 1-D arrays (dt bias,
    A_log, D) drawn N(0, 1) / sqrt(layers), the in_proj parity left to the
    encode. These dt and A are not the published initialisation's (dt
    log-uniform in [time_step_min, time_step_max], A_log = log U[1, 16]):
    the dt at a zero input, softplus(dt_bias), lies above
    ``time_step_max`` in every head, and every head keeps less than 1e-6
    of its state over one published chunk. So the cell's check reads the
    SSM state near the current token, and not what a head held tens of
    tokens back (PERF.md §7); the port's CPU and ``-m cuda`` tests hold
    that on ``model.init``'s published draws."""
    cfg = small_config()
    from repro_torch.models import TPCtx, build
    model = build(port_arch(cfg), TPCtx(tp=4, mode="coded", code_r=2))
    params, _ = weights.make(model, 5, torch.device("cpu"),
                             cfg["vocab_size"])
    m = params["layers"]["mamba2"]
    assert set(m["mixer"]) == {"in_proj", "conv_w", "conv_b", "dt_bias",
                               "a_log", "d_skip", "norm", "out_proj"}
    assert m["mixer"]["in_proj"]["cdc"] is None
    assert abs(float(m["ln"]["g"].mean()) - 1) < 0.05
    assert abs(float(m["mixer"]["norm"]["g"].mean()) - 1) < 0.05
    assert float(m["mixer"]["conv_w"].std()) == pytest.approx(0.5, rel=0.2)
    n_m = m["mixer"]["a_log"].shape[0]
    assert float(m["mixer"]["a_log"].std()) == pytest.approx(
        n_m ** -0.5, rel=0.3)
    published = cells.config(CONFIG)
    dt0 = torch.nn.functional.softplus(m["mixer"]["dt_bias"])
    assert float(dt0.min()) > published["time_step_max"]
    kept = torch.exp(published["chunk_size"] * dt0
                     * -torch.exp(m["mixer"]["a_log"]))
    assert float(kept.max()) < 1e-6


def test_a_cpu_run_of_the_cell_is_correct(monkeypatch):
    """The whole harness on the CPU at smoke size (4 clients on 4 slots,
    short lengths; the Mamba-2 widths of ``small_config``; the pattern
    "M-M*", which holds a layer of each kind in 4): the served tokens are
    the reference's, and the prefills counted their SSD chunks."""
    cell, _, mix = bench_smoke.cell(CELL, gap_limit=1e-4)
    cfg = dict(small_config(), num_hidden_layers=4,
               hybrid_override_pattern="M-M*")
    monkeypatch.setattr(cells, "port_arch", lambda c: dataclasses.replace(
        port_arch(c), pattern=c["hybrid_override_pattern"]))
    run = Run(cell, 2 ** 32 + 99, 3.0, False, device="cpu", cfg=cfg,
              mix=mix)
    run.setup()
    assert run.arch.layer_kinds == "M-M*"
    run.serve()
    run.after_window()
    run.check()
    assert run.correct, run.checks
    res = run.result()
    for name in run.cell["end_to_end"]:
        assert res["metrics"][name]["value"] > 0
    assert run.counters1["mamba2_prefill_chunks"] > \
        run.counters0["mamba2_prefill_chunks"]


def test_sharegpt32_is_sharegpt_with_32_clients():
    a, b = cells.mix("sharegpt"), cells.mix("sharegpt32")
    assert b["params"]["clients"] == 32
    b = copy.deepcopy(b)
    b["params"]["clients"] = a["params"]["clients"]
    assert a == b
    cell = cells.workload(CELL)
    assert (cell["slots"], cell["max_len"]) == (32, 1800)
    assert cell["max_len"] >= b["params"]["prompt"]["max"] \
        + b["params"]["output"]["max"]


# ------------------------------------------------------------- readers ----

def test_prefill_mamba_reads_the_window():
    mod = cells.module("metrics", "prefill_mamba_ms_p50")
    rec = FlightRecorder(timing=True)
    for t, dev in ((9.0, 90.0), (11.0, 3.0), (12.0, 5.0), (13.0, 4.0),
                   (21.0, 70.0)):
        rec.emit("prefill.mamba", track="device", t_ms=t,
                 wall_args={"device_ms": dev, "n": 9})
    run = types.SimpleNamespace(window=(10.0, 20.0), recorder=rec)
    assert mod.read(run) == 4.0 and mod.UNIT == "ms"
    assert mod.read(types.SimpleNamespace(window=(30.0, 40.0),
                                          recorder=rec)) is None
    assert mod.read(types.SimpleNamespace(window=(10.0, 20.0),
                                          recorder=None)) is None


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_mamba2_step_bytes_and_roofline_share():
    cfg = cells.config(CONFIG)
    flops, nbytes = mamba2_costs.step(cfg, 32)
    states = 32 * 256 * 64 * 256
    window = 32 * 3 * 20480
    assert nbytes == 8 * (states + window) + 4 * (
        32 * (20480 + 256 + 16384) + 5 * 20480 + 3 * 256)
    assert flops == 5.0 * states + 32 * (8.0 * 20480 + 2.0 * 16384)
    least = costs.least_seconds(flops, nbytes)
    assert least == nbytes / peaks.HBM_BYTES_PER_S     # bound by bytes
    assert 0.32e-3 < least < 0.33e-3
    mod = cells.module("metrics", "roofline_pct.mamba2_step")
    assert mod.UNIT == "%" and mod.RANGES
    # 9 calls a round: the warm round's 9 are left out, 18 timed at
    # twice the least time each
    ms = 2e3 * least
    calls = [(0.0, _Event(0.0), _Event(1.0))] * 9 \
        + [(0.0, _Event(0.0), _Event(ms))] * 18
    run = types.SimpleNamespace(cfg=cfg, cell=cells.workload(CELL),
                                events={mod.KEY: calls})
    assert mod.read(run) == pytest.approx(50.0)
    run.events = {}
    assert mod.read(run) is None


def test_mamba2_step_is_timed_only_inside_the_eager_rounds(monkeypatch):
    from repro_torch.models import mamba2
    mod = cells.module("metrics", "roofline_pct.mamba2_step")
    step = mamba2.step
    seen = []

    def eager(run, n_rounds=4):
        seen.append(getattr(mamba2.step, "_bench_around", None))
        return {}
    monkeypatch.setattr(probes, "eager_ranges", eager)
    run = types.SimpleNamespace(events={}, clock=None)
    mod.install(run)
    assert probes.eager_ranges is not eager
    assert probes.eager_ranges(run) == {}
    assert seen[0] is not None and mod.KEY in run.events
    assert mamba2.step is step and probes.eager_ranges is eager
    assert json.loads(json.dumps(run.events[mod.KEY])) == []
