"""The port's examples (``repro_torch.examples``) against the reference's
scripts (``examples/*.py``) and library, on the CPU.

quickstart: the coded GEMM on numpy-seeded inputs within 1e-5 of the
reference's ``coded_matmul``, and the smoke granite logits fault-free and
under a dead shard (params converted from the reference's ``init``) within
1e-4 of the reference's ``model.forward``. multi_failure: the decode
condition equal to the reference's to 1e-6 relative, and every recovered
output within ``multi_failure.AGREEMENT[r]`` of the reference's (1e-5 and
1e-4 at r = 1, 2; 1.5e-3 and 1.5e-2 at r = 3, 4, where the solve
amplifies float32 rounding by the decode condition), with a bf16-rounded
parity as the control that must fail it. serve_cdc: every request
completes, the fault-free and with-failure tokens are identical, and under
the reference's params the fault-free tokens are the reference
scheduler's on the same arrivals. train_lm: the ``step,loss`` CSV and
finite losses. Each prints its reference's lines and refuses to run
without a card unless ``--device cpu`` is given.
"""
import functools
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
from repro.models import TPCtx as JCtx, build as jbuild
from repro.runtime import (ContinuousBatchingScheduler as JSched,
                           RuntimeConfig as JRuntimeConfig,
                           ShardHealthController as JHealth,
                           run_arrivals as jrun_arrivals)
from repro.serve import ModelStepper as JStepper
from repro_torch.convert import params_from_jax
from repro_torch.examples import multi_failure, quickstart, serve_cdc, \
    train_lm

EXAMPLES = {"quickstart": quickstart, "serve_cdc": serve_cdc,
            "multi_failure": multi_failure, "train_lm": train_lm}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


# ------------------------------------------------------------ quickstart ----

def test_quickstart_coded_gemm_is_the_reference_s():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 256)).astype(np.float32)
    w = (rng.normal(size=(256, 512)) / 16.0).astype(np.float32)
    valid = quickstart.dead_mask()
    y, ref = quickstart.coded_gemm(torch.from_numpy(x), torch.from_numpy(w),
                                   valid)
    spec = jcore.CodedDenseSpec(jcore.CodeSpec(n_shards=quickstart.T,
                                               n_parity=quickstart.R))
    jy = jax.jit(lambda x, w, v: jcore.coded_matmul(
        x, w, jcore.make_parity_weights(w, spec), spec, v))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(valid))
    np.testing.assert_allclose(y.numpy(), _np(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ref.numpy(), x @ w, rtol=1e-5, atol=1e-5)
    assert float((y - ref).abs().max()) < 1e-4


def test_quickstart_model_under_a_dead_shard_is_the_reference_s():
    jcfg = jsmoke(jget_arch("granite-3-8b"))
    jmodel = jbuild(jcfg, JCtx(tp=quickstart.T, mode="coded",
                               code_r=quickstart.R))
    jparams = jax.jit(lambda k: jmodel.encode_offline(jmodel.init(k)))(
        jax.random.PRNGKey(1))
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 16))
    valid = quickstart.dead_mask()
    model = quickstart.build(quickstart.smoke_config(
        quickstart.get_arch("granite-3-8b")),
        quickstart.TPCtx(tp=quickstart.T, mode="coded",
                         code_r=quickstart.R))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.ctx,
                             device="cpu")
    ok, dead = quickstart.model_under_failure(model, params,
                                              {"tokens": tokens}, valid)
    batch = {"tokens": jnp.asarray(tokens)}
    forward = jax.jit(jmodel.forward)        # one compile for both masks
    jok = _np(forward(jparams, batch, jnp.ones(quickstart.T, bool)))
    jdead = _np(forward(jparams, batch, jnp.asarray(valid)))
    np.testing.assert_allclose(ok.numpy(), jok, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dead.numpy(), jdead, rtol=1e-4, atol=1e-4)
    assert abs(float((ok - dead).abs().max())
               - float(np.abs(jok - jdead).max())) < 1e-4


def test_quickstart_prints_the_reference_s_lines(capsys):
    out = quickstart.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == \
        ["1. coded GEMM", "2. full model", "3. hardware cost"]
    assert lines[2] == ("3. hardware cost: CDC 1.25x vs 2MR 2.00x "
                        "(constant vs linear in devices)")
    assert out["gemm_err"] < 1e-5 and out["model_dev"] < 1e-4


# --------------------------------------------------------- multi_failure ----

@functools.lru_cache(maxsize=None)
def _reference_sweep() -> tuple:
    """The reference script's sweep on numpy-seeded inputs: {r: (cond,
    recovered outputs [SUBSETS, 4, 256])}, and the inputs."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 128)).astype(np.float32)
    w = (rng.normal(size=(128, 256)) / 12.0).astype(np.float32)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    # one compile for each r, the dead subsets its traced mask
    coded = jax.jit(jcore.coded_matmul, static_argnums=(3,))
    out = {}
    for r in multi_failure.RS:
        spec = jcore.CodedDenseSpec(jcore.CodeSpec(multi_failure.T, r),
                                    layout="dedicated")
        w_cdc = jcore.make_parity_weights(jw, spec)
        ys = []
        for dead in itertools.islice(
                itertools.combinations(range(multi_failure.T), r),
                multi_failure.SUBSETS):
            valid = jnp.ones(multi_failure.T, bool).at[
                jnp.asarray(dead)].set(False)
            ys.append(_np(coded(jx, jw, w_cdc, spec, valid)))
        out[r] = (jcore.max_decode_condition(spec.code), np.stack(ys))
    return out, x, w


@pytest.mark.parametrize("r", multi_failure.RS)
def test_multi_failure_sweep_is_the_reference_s(r):
    """The decode condition to 1e-6 relative, and every recovered output
    within ``multi_failure.AGREEMENT[r]`` of the reference's, elementwise
    (so the worst errors too: within 1e-4 of each other up to r = 2)."""
    want, x, w = _reference_sweep()
    row = multi_failure.sweep_r(torch.from_numpy(x), torch.from_numpy(w), r)
    assert row["r"] == r
    assert row["cond"] == pytest.approx(want[r][0], rel=1e-6)
    gap = np.abs(row["outputs"].numpy() - want[r][1]).max()
    assert gap <= multi_failure.AGREEMENT[r]
    assert row["worst"] == pytest.approx(
        float(np.abs(row["outputs"].numpy() - x @ w).max()))


@pytest.mark.parametrize("r", multi_failure.RS)
def test_multi_failure_agreement_rejects_a_bf16_parity(r):
    """The control: the same sweep with its parity weights rounded to bf16
    lies beyond ``AGREEMENT[r]`` of the reference's outputs."""
    want, x, w = _reference_sweep()
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    spec = multi_failure.CodedDenseSpec(
        multi_failure.CodeSpec(multi_failure.T, r), layout="dedicated")
    w_cdc = multi_failure.make_parity_weights(wt, spec).bfloat16().float()
    ys = []
    for dead in itertools.islice(
            itertools.combinations(range(multi_failure.T), r),
            multi_failure.SUBSETS):
        valid = np.ones(multi_failure.T, bool)
        valid[list(dead)] = False
        ys.append(multi_failure.coded_matmul(xt, wt, w_cdc, spec, valid,
                                             use_fused=True).numpy())
    assert np.abs(np.stack(ys) - want[r][1]).max() \
        > 10 * multi_failure.AGREEMENT[r]


def test_multi_failure_prints_the_reference_s_lines(capsys):
    rows = multi_failure.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [row["r"] for row in rows] == list(multi_failure.RS)
    for r, ln in zip(multi_failure.RS, lines):
        assert ln.startswith(f"r={r}: tolerates any {r} failures | hw cost "
                             f"{(8 + r) / 8:.3f}x (vs {r + 1:.1f}x modular)")
        assert "| worst err " in ln and "| decode cond " in ln


# ------------------------------------------------------------- serve_cdc ----

def test_serve_cdc_completes_every_request_identically(capsys):
    out = serve_cdc.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert out["completed"] == out["requests"] == 6
    assert out["tokens_ok"] == out["tokens_fail"]
    assert all(len(t) == 12 for t in out["tokens_ok"].values())
    assert out["counters"]["erasures_recovered"] == 1
    assert out["counters"]["requests_completed"] == 6
    for head in ("fault-free tokens[req 0]:", "with-failure tokens[req 0]:",
                 "all requests completed: True",
                 "identical across all requests: True", "runtime metrics:",
                 "batched executor:", "measured round latency:",
                 "modelled straggler first-T-of-(T+r):"):
        assert head in text
    # no card: eager rounds, no graph
    assert f"{out['rounds']} single-dispatch rounds, 0 graph capture(s), " \
        f"0 replay(s)" in text


def test_serve_cdc_tokens_are_the_reference_scheduler_s():
    """Under the reference's ``init(PRNGKey(0))`` params the port's stream
    gives the reference scheduler's tokens on the same arrivals."""
    jcfg = jsmoke(jget_arch(serve_cdc.ARCH))
    jmodel = jbuild(jcfg, JCtx(tp=4, mode="coded", code_r=2,
                               moe_capacity=0))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    work = serve_cdc.arrivals(jcfg.vocab)
    stepper = JStepper(jmodel, jparams, max_len=64)
    sched = JSched(stepper, JRuntimeConfig(n_slots=2),
                   health=JHealth(stepper.n_shards, stepper.erasure_budget,
                                  events=[]))
    want = {r.rid: list(map(int, r.tokens))
            for r in jrun_arrivals(sched, list(work))}
    model = serve_cdc.make_model()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.ctx,
                             device="cpu")
    _, got = serve_cdc.serve(model, params, work, [])
    assert got[0] == want[0]
    assert got == want


# -------------------------------------------------------------- train_lm ----

def test_train_lm_prints_the_loss_csv(tmp_path, capsys):
    out = train_lm.main(["--steps", "2", "--seq", "32", "--batch", "2",
                         "--ckpt", str(tmp_path / "ck"), "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "step,loss"
    step, loss = lines[1].split(",")
    assert int(step) == 2 and math.isfinite(float(loss))
    assert lines[-1].startswith("# loss ") and "over 2 steps" in lines[-1]
    assert out["finite"] and [s for s, _ in out["losses"]] == [2]


# ---------------------------------------------------------------- device ----

@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_refuses_to_run_without_a_card(monkeypatch, tmp_path, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--ckpt", str(tmp_path / "ck")] if name == "train_lm" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EXAMPLES[name].main(argv)
    assert not (tmp_path / "ck").exists()
