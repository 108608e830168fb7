"""The timing flight recorder's device spans on the card (``-m cuda``;
skipped without one): they add no synchronise, and agree with CUDA
events around the same calls from outside within 2%. No JAX here.

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_timing_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.obs.tracer import FlightRecorder
from repro_torch.runtime import ContinuousBatchingScheduler, RuntimeConfig
from repro_torch.runtime.clock import WallClock


@pytest.mark.cuda
def test_device_spans_add_no_synchronise_and_match_outside_events(
        monkeypatch):
    """On the card, granite-3-8b at full width in 8 layers: a timed run
    makes as many synchronising calls as an untimed one, and each round's
    and prefill's device ms agree with CUDA events recorded around
    ``VStep.round`` and ``ModelStepper.prefill`` from outside within 2%
    (the run's last round is dispatched and never harvested)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.device import set_true_f32
    from repro_torch.models import TPCtx, build
    from repro_torch.serve import ModelStepper
    set_true_f32()
    cfg = dataclasses.replace(get_arch("granite-3-8b"), n_layers=8)
    model = build(cfg, TPCtx(tp=4, mode="coded", code_r=2))
    stepper = ModelStepper(model, model.init(0, device="cuda"),
                           max_len=1024)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 300 + 50 * i) for i in range(4)]
    calls = {"n": 0}

    def counted(fn):
        def call(*a, **kw):
            calls["n"] += 1
            return fn(*a, **kw)
        return call

    def run(recorder):
        sched = ContinuousBatchingScheduler(
            stepper, RuntimeConfig(n_slots=2), clock=WallClock(),
            tracer=recorder)
        outside = {"round": [], "prefill": []}
        for obj, attr in ((sched.executor.vstep, "round"),
                          (stepper, "prefill")):
            fn = getattr(obj, attr)

            def timed(*a, _fn=fn, _key=attr, **kw):
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
                out = _fn(*a, **kw)
                e.record()
                outside[_key].append((s, e))
                return out
            monkeypatch.setattr(obj, attr, timed)
        torch.cuda.synchronize()
        calls["n"] = 0
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "synchronize",
                      counted(torch.cuda.synchronize))
            m.setattr(torch.cuda.Event, "synchronize",
                      counted(torch.cuda.Event.synchronize))
            for p in prompts:
                sched.submit(p, 12)
            sched.run()
            n = calls["n"]
        torch.cuda.synchronize()
        monkeypatch.undo()
        sched.attach_tracer(None)
        return sched, n, {k: [s.elapsed_time(e) for s, e in v]
                          for k, v in outside.items()}

    _, n_plain, _ = run(None)
    rec = FlightRecorder(timing=True)
    sched, n_timed, outside = run(rec)
    assert n_timed == n_plain
    rounds = [e.wall_args["device_ms"]
              for e in rec.by_kind("round.harvest")]
    prefills = [e.wall_args["device_ms"] for e in rec.by_kind("host.admit")]
    assert 0 < len(rounds) == len(outside["round"]) - 1
    assert len(prefills) == len(outside["prefill"]) == len(prompts)
    np.testing.assert_allclose(rounds, outside["round"][:-1], rtol=0.02)
    np.testing.assert_allclose(prefills, outside["prefill"], rtol=0.02)
    assert sched.executor.vstep.n_replays > 0
    assert {"graph_captures", "cuda_alloc_retries"} <= \
        set(sched.metrics.counters)
