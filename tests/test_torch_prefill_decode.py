"""The prefill's decode of its coded GEMMs through the decode-and-merge
kernel (``TPCtx.fused_decode``), on the CPU at smoke size, where the model
is built with the choice on and the kernel's plain version runs. No JAX
here: the oracle is the port's own reference decode (a stepper over the
same params whose model leaves the choice off).

  * all shards valid: the prefill's logits and state equal the
    reference-decode prefill's to the bit, and every coded GEMM (5 a
    layer and the head) decodes through the kernel once;
  * each single dead shard: they agree within 1e-5;
  * 2 dead shards (r = 4 folded): the prefill takes the reference decode
    (the same logits to the bit), and the scheduler's
    ``prefill_reference_decode`` counts it; with every shard valid
    ``prefill_fused_decode`` counts every admission;
  * a model built without the choice, on the CPU: the stepper never sets
    it and the scheduler registers neither counter.

The card's test (no synchronisation in a warmed prefill) is in
test_torch_prefill_decode_cuda.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, smoke_config
from repro_torch.kernels import ops
from repro_torch.models import TPCtx, build
from repro_torch.runtime import (ContinuousBatchingScheduler, RuntimeConfig,
                                 ShardHealthController, erasure)
from repro_torch.serve import ModelStepper
from repro_torch.tree import leaves

T = 4
ARCHS = ("granite-3-8b", "qwen2-moe-a2.7b")
COUNTERS = {"prefill_fused_decode", "prefill_reference_decode"}
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's smoke-size ops: the suite runs
    in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _steppers(name: str, code_r: int = 2) -> tuple[ModelStepper,
                                                   ModelStepper]:
    """(reference, fused): steppers over the same params, whose model
    leaves the choice off or is built with it on."""
    cfg = smoke_config(get_arch(name))
    ctx = TPCtx(tp=T, mode="coded", code_r=code_r, moe_capacity=0)
    model = build(cfg, ctx)
    params = model.init(0, device="cpu")
    fused = build(cfg, dataclasses.replace(ctx, fused_decode=True))
    return (ModelStepper(model, params, max_len=48),
            ModelStepper(fused, params, max_len=48))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _steppers(request.param)


def _batch(stepper, seed: int = 3, n: int = 13) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, stepper.model.cfg.vocab, (1, n))}


def _mask(dead=()) -> np.ndarray:
    v = np.ones(T, bool)
    v[list(dead)] = False
    return v


def _prefill(stepper, mask, monkeypatch=None):
    """(logits, state leaves, kernel calls) of one prefill."""
    calls = []
    real = ops.cdc_decode_merge
    if monkeypatch is not None:
        monkeypatch.setattr(ops, "cdc_decode_merge",
                            lambda *a: calls.append(1) or real(*a))
    try:
        logits, state = stepper.prefill(_batch(stepper), mask)
    finally:
        if monkeypatch is not None:
            monkeypatch.setattr(ops, "cdc_decode_merge", real)
    return logits, leaves(state), len(calls)


def test_all_valid_prefill_equals_the_reference_decode_to_the_bit(
        pair, monkeypatch):
    reference, fused = pair
    cfg = fused.model.cfg
    want, want_state, n_ref = _prefill(reference, _mask(), monkeypatch)
    assert reference.last_prefill_decode is None and n_ref == 0
    got, got_state, n_fused = _prefill(fused, _mask(), monkeypatch)
    assert fused.last_prefill_decode == "fused"
    assert n_fused == 5 * cfg.n_layers + 1
    assert torch.equal(got, want)
    assert len(got_state) == len(want_state)
    for g, w in zip(got_state, want_state):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dead", range(T))
def test_single_dead_shard_prefill_agrees_with_the_reference_decode(
        pair, dead, monkeypatch):
    reference, fused = pair
    want, want_state, _ = _prefill(reference, _mask([dead]))
    got, got_state, n = _prefill(fused, _mask([dead]), monkeypatch)
    assert fused.last_prefill_decode == "fused" and n > 0
    torch.testing.assert_close(got, want, **TOL)
    for g, w in zip(got_state, want_state):
        torch.testing.assert_close(g, w, **TOL)


def test_two_dead_shards_fall_back_and_are_counted(monkeypatch):
    reference, stepper = _steppers("granite-3-8b", code_r=4)
    dead = _mask([1, 2])
    want, _, _ = _prefill(reference, dead)
    got, _, n = _prefill(stepper, dead, monkeypatch)
    assert stepper.last_prefill_decode == "reference" and n == 0
    assert torch.equal(got, want)

    prompts = [_batch(stepper, seed=s, n=6)["tokens"][0] for s in range(3)]
    counts = {}
    for events in ((), (erasure(0.0, 1), erasure(0.0, 2))):
        health = ShardHealthController(T, stepper.erasure_budget,
                                       events=list(events))
        sched = ContinuousBatchingScheduler(
            stepper, RuntimeConfig(n_slots=2), health=health)
        for p in prompts:
            sched.submit(p, 3)
        assert len(sched.run()) == len(prompts)
        c = sched.metrics.counters
        counts[len(events)] = (c["requests_admitted"],
                               c["prefill_fused_decode"],
                               c["prefill_reference_decode"])
    assert counts[0] == (3, 3, 0)
    assert counts[2] == (3, 0, 3)


def test_cpu_stepper_leaves_the_choice_off(monkeypatch):
    stepper, _ = _steppers("granite-3-8b")
    assert not stepper.fused_prefill_on

    def refuse(*a, **kw):
        raise AssertionError("the decode-and-merge kernel ran on the CPU")
    monkeypatch.setattr(ops, "fused_decode_merge", refuse)
    stepper.prefill(_batch(stepper), _mask([2]))
    assert stepper.last_prefill_decode is None
    sched = ContinuousBatchingScheduler(stepper, RuntimeConfig(n_slots=2))
    sched.submit(_batch(stepper)["tokens"][0], 3)
    assert len(sched.run()) == 1
    assert not COUNTERS & set(sched.metrics.counters)
