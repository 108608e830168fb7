"""The four metrics read from the port's own spans (``harness.recorder``):
on hand-made recorders, each reads only the events that began in the
window and returns None where there is nothing to read; ``install``
attaches one timing recorder, once, and none to a port without one; and
a whole run on the CPU at smoke size gives the two host metrics (the
device ones need a card)."""
import types

import pytest

import bench_smoke
from harness import cells, recorder
from harness.run import Run
from repro_torch.obs.tracer import FlightRecorder

METRICS = ("prefill_launch_ms_p50", "admit_stall_ms_p50", "round_device_ms",
           "prefill_device_ms_p50")


def _run(rec, window=(10.0, 20.0)):
    run = types.SimpleNamespace(window=window)
    run.recorder = rec
    return run


def _read(name, run):
    return cells.module("metrics", name).read(run)


def _recorder():
    rec = FlightRecorder(timing=True)
    # (t_ms, wall ms, device ms): the first and the last fall outside
    for t, wall, dev in ((9.0, 900.0, 800.0), (11.0, 30.0, 10.0),
                         (12.0, 50.0, 40.0), (13.0, 40.0, 20.0),
                         (21.0, 700.0, 600.0)):
        rec.emit("host.prefill.forward", track="host", t_ms=t,
                 wall_dur_ms=wall / 2)
        rec.emit("host.admit", track="host", t_ms=t, wall_dur_ms=wall,
                 rid=int(t), prompt_len=8,
                 wall_args={"device_ms": dev, "device_t_ms": t})
        rec.emit("round.harvest", track="rounds", t_ms=t + 0.5,
                 wall_dur_ms=wall, wall_args={"device_ms": dev / 10})
    # an untimed harvest carries no device ms and is left out
    rec.emit("round.harvest", track="rounds", t_ms=15.0, wall_dur_ms=3.0)
    return rec


def test_each_metric_reads_the_window():
    run = _run(_recorder())
    assert _read("prefill_launch_ms_p50", run) == 20.0
    assert _read("admit_stall_ms_p50", run) == 40.0
    assert _read("prefill_device_ms_p50", run) == 20.0
    assert _read("round_device_ms", run) == pytest.approx(
        (1.0 + 4.0 + 2.0) / 3)
    for name in METRICS:
        mod = cells.module("metrics", name)
        assert mod.UNIT == "ms" and mod.install is recorder.install


@pytest.mark.parametrize("name", METRICS)
def test_nothing_to_read_is_none(name):
    assert _read(name, _run(None)) is None
    assert _read(name, _run(FlightRecorder(timing=True))) is None
    assert _read(name, _run(_recorder(), window=(30.0, 40.0))) is None


def test_install_attaches_one_timing_recorder():
    calls = []
    run = types.SimpleNamespace(sched=types.SimpleNamespace(
        attach_tracer=calls.append))
    recorder.install(run)
    recorder.install(run)
    assert calls == [run.recorder] and run.recorder.timing
    # a port without attach_tracer: nothing attached, nothing read
    old = types.SimpleNamespace(sched=object(), window=(0.0, 1.0))
    recorder.install(old)
    assert old.recorder is None
    assert _read("admit_stall_ms_p50", old) is None


def test_a_cpu_run_reads_the_host_metrics():
    cell, cfg, mix = bench_smoke.cell("granite-3-8b.conv10")
    run = Run(cell, 2 ** 32 + 11, 1.5, False, device="cpu", cfg=cfg,
              mix=mix)
    run.setup()
    recorder.install(run)
    try:
        run.serve()
    finally:
        run.sched.attach_tracer(None)
    got = {name: _read(name, run) for name in METRICS}
    assert got["prefill_launch_ms_p50"] > 0
    assert got["admit_stall_ms_p50"] >= got["prefill_launch_ms_p50"]
    assert got["round_device_ms"] is None
    assert got["prefill_device_ms_p50"] is None
    assert run.recorder.dropped == 0
