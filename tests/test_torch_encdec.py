"""The port's encoder-decoder (whisper-medium, smoke size) against the
reference.

The reference initialises the params and ``params_from_jax`` carries them
over, so both sides hold the same weights; inputs come from numpy seeds.
Held against the JAX package: the config, LayerNorm and the sinusoidal
table, ``encode``, ``forward`` and ``init_decode`` + ``decode`` (within
1e-4, plain and coded at T = 4, r = 2 folded, under every single dead
shard), decode with the cross-attention streamed in chunks, and greedy
tokens through the serving engine, both executors with fresh frames per
request, the scheduler across a mid-run failure, heal and re-encode, and
``launch.serve``. Also: the blank executor state runs no coded GEMM, and
the perf counter reads the cross-attention bank once a round.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
from repro.launch import serve as jserve
from repro.models import TPCtx as JCtx, build as jbuild
from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro.runtime import (ContinuousBatchingScheduler as JScheduler,
                           RuntimeConfig as JRuntimeConfig,
                           ShardHealthController as JHealth,
                           erasure as jerasure, run_arrivals as jrun_arrivals)
from repro.serve import ModelStepper as JStepper
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro_torch.configs import get_arch, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import TPCtx, build, common, encdec
from repro_torch.obs import perf
from repro_torch.runtime import (ContinuousBatchingScheduler, RuntimeConfig,
                                 ShardHealthController, erasure,
                                 run_arrivals)
from repro_torch.runtime.executor import SlotPoolExecutor, slotbatch
from repro_torch.serve import ModelStepper, ServeConfig, ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
T, R = 4, 2
NAME = "whisper-medium"
GEN = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's smoke-size ops: the suite runs
    in several worker processes at once, and their thread pools would
    contend for the cores (4x slower here under that load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def masks():
    """The all-valid mask and every single dead shard."""
    return [np.ones(T, bool)] + [np.arange(T) != d for d in range(T)]


@functools.lru_cache(maxsize=None)
def _pair(mode: str = "coded", enc_seq: int | None = None):
    """(reference model, its params, port model, port params) of whisper
    at smoke size (``enc_seq`` frames if given), in ``mode``."""
    jcfg, cfg = jsmoke(jget_arch(NAME)), smoke_config(get_arch(NAME))
    if enc_seq is not None:
        jcfg = dataclasses.replace(jcfg, enc_seq=enc_seq)
        cfg = dataclasses.replace(cfg, enc_seq=enc_seq)
    jmodel = jbuild(jcfg, JCtx(tp=T, mode=mode, code_r=R, moe_capacity=0))
    jparams = jmodel.encode_offline(jmodel.init(jax.random.PRNGKey(0)))
    model = build(cfg, TPCtx(tp=T, mode=mode, code_r=R))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.ctx,
                             device="cpu")
    return jmodel, jparams, model, params


def _frames(cfg, b: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(b, cfg.enc_seq, cfg.d_model)).astype(np.float32)


# ----------------------------------------------------------- the config ----

def test_config_and_smoke_config_match_reference():
    cfg, jcfg = get_arch(NAME), jget_arch(NAME)
    for full, jfull in ((cfg, jcfg), (smoke_config(cfg), jsmoke(jcfg))):
        for f in dataclasses.fields(full):
            assert getattr(full, f.name) == getattr(jfull, f.name), f.name
    small = smoke_config(cfg)
    assert (small.encoder_layers, small.enc_seq, small.n_layers) == (2, 16, 2)
    assert cfg.is_encdec and (cfg.d_model, cfg.hd, cfg.vocab) == \
        (1024, 64, 51865)


def test_layernorm_and_position_table_match_reference():
    """LayerNorm (float32 math, biased variance) within 1e-6, also on a
    bf16 input, and the sinusoidal table (sin in the even columns, cos in
    the odd ones) within 1e-5 over the rows a served request reads (the
    two libraries round float32 exp, sin and cos differently: 1.9e-6
    apart at 37 rows; row p's argument carries p times the rounding of
    its frequency, so far rows drift, 4.9e-4 apart near row 8191)."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 5, 128)) * 3 + 1).astype(np.float32)
    p = {"g": rng.normal(size=128).astype(np.float32),
         "b": rng.normal(size=128).astype(np.float32)}
    want = np.asarray(jcommon.layernorm(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), 1e-5))
    got = common.layernorm({k: torch.as_tensor(v) for k, v in p.items()},
                           torch.as_tensor(x), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    assert common.layernorm({k: torch.as_tensor(v) for k, v in p.items()},
                            xb).dtype == torch.bfloat16
    for seq, d in ((37, 128), (8192, 1024)):
        np.testing.assert_allclose(
            common.sinusoidal_pos(seq, d)[:64].numpy(),
            np.asarray(jcommon.sinusoidal_pos(seq, d))[:64], rtol=1e-5,
            atol=1e-5)


def test_params_carry_over_and_parity_is_re_encoded():
    """``params_from_jax`` walks whisper's tree (enc_layers, enc_ln_f,
    dec_layers.{self,cross,ffn,ln1,ln_x,ln2}, dec_ln_f, lm_head, embed):
    same keys and shapes; the 12 parity leaves are the port's own encode
    of the carried weights and agree with the reference's within 1e-5."""
    _, jparams, model, params = _pair()

    def leaves(node, path=()):
        if isinstance(node, dict):
            return {k: v for key, sub in node.items()
                    for k, v in leaves(sub, path + (key,)).items()}
        return {path: node}

    jl, tl = leaves(jax.tree.map(np.asarray, jparams)), leaves(params)
    assert set(jl) == set(tl)
    assert set(params["dec_layers"]) == {"ln1", "self", "ln_x", "cross",
                                         "ln2", "ffn"}
    cdc = [k for k in tl if k[-1] == "cdc"]
    assert len(cdc) == 12
    for k in tl:
        assert tuple(tl[k].shape) == jl[k].shape, k
        np.testing.assert_allclose(tl[k].numpy(), jl[k], rtol=1e-5,
                                   atol=1e-5, err_msg=str(k))


def test_gelu_ffn_matches_reference():
    """The non-gated GELU FFN (w1, tanh GELU, w2) at whisper's smoke
    width, coded under every single dead shard: within 1e-4."""
    from repro.models import ffn as jffn
    from repro_torch.models import ffn as tffn
    from repro_torch.models.common import tree_index
    jmodel, jparams, model, params = _pair()
    x = np.random.default_rng(9).normal(size=(2, 5, 128)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["dec_layers"]["ffn"])
    tp = tree_index(params["dec_layers"]["ffn"], 0)
    assert "w3" not in tp and model.cfg.act == "gelu"
    for valid in masks():
        want = np.asarray(jffn.ffn(jmodel.ctx, jp, jmodel.cfg,
                                   jnp.asarray(x), jnp.asarray(valid)))
        got = tffn.ffn(model.ctx, tp, model.cfg, torch.as_tensor(x), valid)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


# --------------------------------------------------------- model parity ----

@pytest.mark.parametrize("mode", ["plain", "coded"])
def test_encode_and_forward_match_reference(mode):
    """``encode`` and the teacher-forced ``forward`` (logits [B, S, vocab])
    within 1e-4 of the reference's, plain and coded, the coded ones under
    every single dead shard."""
    jmodel, jparams, model, params = _pair(mode)
    cfg = model.cfg
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 6))
    frames = _frames(cfg, 2)
    jenc = jax.jit(lambda p, f, v: jencdec.encode(jmodel.cfg, p, jmodel.ctx,
                                                  f, v))
    jfwd = jax.jit(jmodel.forward)
    for valid in masks() if mode == "coded" else [None]:
        jv = None if valid is None else jnp.asarray(valid)
        want = np.asarray(jenc(jparams, jnp.asarray(frames), jv))
        got = encdec.encode(cfg, params, model.ctx, torch.as_tensor(frames),
                            valid)
        np.testing.assert_allclose(got.numpy(), want, **TOL,
                                   err_msg=f"encode, mask {valid}")
        want = np.asarray(jfwd(jparams, {"tokens": jnp.asarray(toks),
                                         "frames": jnp.asarray(frames)}, jv))
        got = model.forward(params, {"tokens": toks, "frames": frames},
                            valid)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL,
                                   err_msg=f"forward, mask {valid}")


@functools.lru_cache(maxsize=None)
def _jitted(jmodel, kv_chunk):
    """The reference's decode and init_decode, compiled once (the mask is
    traced)."""
    return (jax.jit(functools.partial(jmodel.decode, kv_chunk=kv_chunk)),
            jax.jit(lambda p, batch, valid: jmodel.init_decode(
                p, batch, 2, 16, jnp.float32, valid=valid, per_row=True)))


def _decode_pair(jmodel, jparams, model, params, valid, kv_chunk=1024,
                 steps=3):
    """Prefill 6 tokens and decode ``steps`` greedy tokens on both sides
    (the reference's next token feeds both); logits compared per step."""
    cfg = model.cfg
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32),
             "frames": _frames(cfg, 2, seed=4)}
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.as_tensor(valid)
    jdecode, jinit = _jitted(jmodel, kv_chunk)
    jst = jinit(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jv)
    st = model.init_decode(params, batch, 2, 16, torch.float32, valid=tv)
    tok = batch["tokens"]
    for step in range(steps + 1):
        jl, jst = jdecode(jparams, jst, jnp.asarray(tok), jv)
        tl, st = model.decode(params, st, torch.as_tensor(tok), valid,
                              kv_chunk=kv_chunk)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"mask {valid}, step {step}")
        tok = np.asarray(jl)[:, -1:].argmax(-1).astype(np.int32)
    return st


@pytest.mark.parametrize("mode", ["plain", "coded"])
def test_init_decode_and_decode_match_reference(mode):
    """init_decode (the encoder and the cross-attention bank) + a 6-token
    prefill + 3 decode steps: logits within 1e-4 of the reference's at
    every step, plain and coded under every single dead shard. The bank
    keeps the reference's shapes, stored heads-major."""
    jmodel, jparams, model, params = _pair(mode)
    for valid in masks() if mode == "coded" else [None]:
        st = _decode_pair(jmodel, jparams, model, params, valid)
    cfg = model.cfg
    bank = st["xkv"]["k"]
    assert bank.shape == (cfg.n_layers, 2, cfg.enc_seq, cfg.n_kv_heads,
                          cfg.hd)
    assert bank.transpose(2, 3).is_contiguous()
    assert st["xkv"]["pos"].shape == (cfg.n_layers, 2, cfg.enc_seq)
    assert (st["xkv"]["pos"] == torch.arange(cfg.enc_seq)).all()


def test_decode_streams_the_bank_in_chunks():
    """40 frames against kv_chunk 16: the cross-attention streams the
    bank in chunks of 16, 16 and 8 (the reference pads the last to 16 and
    masks the pad) through the online softmax; logits within 1e-4, all
    shards valid and shard 3 dead."""
    pair = _pair("coded", enc_seq=40)
    for valid in (masks()[0], masks()[4]):
        _decode_pair(*pair, valid, kv_chunk=16, steps=2)


# ------------------------------------------------------------- serving ----

@functools.lru_cache(maxsize=None)
def _reference_stream():
    """Two requests with frames and the reference engine's 8-token
    streams, shard 1 erased at step 3."""
    jmodel, jparams, model, _ = _pair()
    cfg = model.cfg
    batch = {"tokens": np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 7)).astype(np.int32), "frames": _frames(cfg, 2, 6)}
    return batch, JEngine(jmodel, jparams, JServeConfig(
        max_len=24, batch=2, cache_dtype=jnp.float32)).generate(
        batch, 8, fail_at={3: 1})


@pytest.mark.parametrize("use_fused", [True, False],
                         ids=["fused", "reference"])
def test_engine_stream_with_frames_matches_reference(use_fused):
    """ServingEngine.generate with per-row frames, shard 1 erased at step
    3: tokens identical to the reference engine's, on the fused round (the
    kernels' plain versions here) and on the reference variant; the
    sequential oracle agrees."""
    _, _, model, params = _pair()
    batch, want = _reference_stream()
    eng = ServingEngine(model, params, ServeConfig(max_len=24, batch=2),
                        use_fused=use_fused)
    np.testing.assert_array_equal(eng.generate(batch, 8, fail_at={3: 1}),
                                  want)
    eng.valid[:] = True
    np.testing.assert_array_equal(
        eng._generate_sequential(batch, 8, fail_at={3: 1}), want)


def _extras(cfg, rng):
    """Fresh frames per request, drawn after its prompt (the reference's
    executor conformance suite draws them so)."""
    return {"frames": rng.normal(size=(cfg.enc_seq, cfg.d_model))
            .astype(np.float32)}


def _staggered(cfg, n, base_len=4, seed=3):
    """Prompts of different lengths arriving at different times, more
    than the slots: slots sit at different positions and are reused."""
    rng = np.random.default_rng(seed)
    return [(i * 1.5, rng.integers(0, cfg.vocab, base_len + i % 3), GEN,
             _extras(cfg, rng)) for i in range(n)]


def _serve(side, stepper, arrivals, events=(), **rcfg):
    rt = {"jax": (JScheduler, JRuntimeConfig, JHealth, jrun_arrivals,
                  jerasure),
          "port": (ContinuousBatchingScheduler, RuntimeConfig,
                   ShardHealthController, run_arrivals, erasure)}[side]
    sched_cls, rcfg_cls, health_cls, run, erase = rt
    health = health_cls(stepper.n_shards, stepper.erasure_budget,
                        events=[erase(t, s) for t, s in events])
    sched = sched_cls(stepper, rcfg_cls(**rcfg), health=health)
    done = run(sched, arrivals)
    return sched, {r.rid: list(r.tokens) for r in done}


@pytest.fixture(scope="module")
def steppers():
    jmodel, jparams, model, params = _pair()
    return (JStepper(jmodel, jparams, max_len=48),
            ModelStepper(model, params, max_len=48), model.cfg)


def test_executors_with_fresh_frames_match_reference(steppers):
    """Six staggered requests with fresh frames each on four slots: the
    batched executor and the sequential oracle give identical tokens,
    equal to the reference executor's."""
    jst, st, cfg = steppers
    arrivals = _staggered(cfg, 6)
    _, want = _serve("jax", jst, arrivals, n_slots=4)
    runs = {}
    for name, kw in (("sequential", dict(batched=False)),
                     ("batched", dict(overlap=True))):
        sched, runs[name] = _serve("port", st, arrivals, n_slots=4, **kw)
        assert (sched.executor is None) == (name == "sequential")
    assert len(want) == 6 and all(len(t) == GEN for t in want.values())
    for name, toks in runs.items():
        assert toks == want, name


def test_scheduler_heals_and_reencodes_like_the_reference(steppers):
    """Three requests with frames on two slots: an in-budget erasure is
    recovered in-step, two concurrent erasures take the 2MR path (requeue,
    replica swap, re-encode; the re-admission runs the encoder again).
    Every run gives the fault-free tokens; the 2MR run also the
    reference's tokens and counters."""
    jst, st, cfg = steppers
    rng = np.random.default_rng(11)
    frames = rng.normal(size=(cfg.enc_seq, cfg.d_model)).astype(np.float32)
    prng = np.random.default_rng(7)
    prompts = [prng.integers(0, cfg.vocab, 8) for _ in range(3)]
    arrivals = [(0.0, p, GEN, {"frames": frames}) for p in prompts]
    _, ok = _serve("port", st, arrivals, n_slots=2)
    cdc, got = _serve("port", st, arrivals, [(2.0, 1)], n_slots=2)
    assert got == ok and len(ok) == 3
    assert cdc.metrics.counters["erasures_recovered"] == 1
    assert cdc.metrics.counters["beyond_budget_failures"] == 0
    events = [(2.0, 1), (3.0, 2)]
    js, want = _serve("jax", jst, arrivals, events, n_slots=2)
    ts, got = _serve("port", st, arrivals, events, n_slots=2)
    assert got == want == ok
    c = dict(ts.metrics.counters)
    assert c == dict(js.metrics.counters)
    assert c["beyond_budget_failures"] == 1
    assert c["requests_requeued"] >= 1 and c["parity_reencodes"] >= 1
    assert ts.health.mask.all()


def test_blank_state_runs_no_coded_gemm(steppers, monkeypatch):
    """The executor's blank state is allocated from the layout: no coded
    GEMM is launched or costed, and the encoder never runs."""
    _, st, cfg = steppers
    monkeypatch.setattr(encdec, "encode", lambda *a, **k: pytest.fail(
        "the blank state ran the encoder"))
    counter = perf.count_round(lambda: slotbatch.blank_state(st, 4))
    assert counter.kernels == {} and counter.flops == 0
    state = slotbatch.blank_state(st, 4)
    assert state["xkv"]["k"].shape == (cfg.n_layers, 4, cfg.enc_seq,
                                       cfg.n_kv_heads, cfg.hd)
    assert not any(t.any() for t in (state["xkv"]["k"], state["kv"]["k"]))


def test_perf_counts_the_cross_bank_once():
    """The fused round's counted bytes grow with the frames by the bank's
    bytes plus the attention scores' passes (14% of it at hd = 32), and
    never by the state's copy (the cost round runs on clones made before
    counting): 48 frames against 16."""
    counted, bank = [], []
    for enc_seq in (16, 48):
        _, _, model, params = _pair("coded", enc_seq=enc_seq)
        st = ModelStepper(model, params, max_len=24)
        ex = SlotPoolExecutor(st, 4, overlap=False, use_fused=True)
        ex.active[:] = True
        ex.step_round(np.ones(T, bool))
        cost = perf.attribute_round_costs(ex.vstep, ex.state,
                                          ex.last_toks)["fused"]
        counted.append(cost.bytes)
        xkv = ex.state["xkv"]
        bank.append(sum(t.numel() * t.element_size() for t in xkv.values()))
    grew, bank_grew = counted[1] - counted[0], bank[1] - bank[0]
    assert bank_grew <= grew <= 1.2 * bank_grew, (grew, bank_grew)


def _arrivals_of(monkeypatch, module, argv, run_real: bool):
    """The arrivals ``module.main`` hands its scheduler (the run itself
    is skipped unless ``run_real``), and the scheduler."""
    seen = {}
    real = module.run_arrivals

    def record(sched, arrivals):
        seen["arrivals"], seen["sched"] = arrivals, sched
        return real(sched, arrivals) if run_real else []

    monkeypatch.setattr(module, "run_arrivals", record)
    if run_real:
        module.main(argv)
    else:
        monkeypatch.setattr("sys.argv", ["serve"] + argv)
        module.main()
    return seen


def test_launch_serve_whisper_completes_with_the_reference_requests(
        monkeypatch, capsys):
    """``launch.serve --arch whisper-medium --smoke --coded --device cpu``
    completes every request, and hands its scheduler the same prompts and
    frames, in the same order, as the reference's launcher."""
    argv = ["--arch", NAME, "--smoke", "--coded", "--requests", "4",
            "--gen-tokens", "4", "--prompt-len", "5"]
    want = _arrivals_of(monkeypatch, jserve, argv, run_real=False)
    got = _arrivals_of(monkeypatch, tserve, argv + ["--device", "cpu"],
                       run_real=True)
    assert "completed 4/4 requests" in capsys.readouterr().out
    assert len(got["arrivals"]) == len(want["arrivals"]) == 4
    for (t, p, n, ex), (jt, jp, jn, jex) in zip(got["arrivals"],
                                                want["arrivals"]):
        assert (t, n) == (jt, jn)
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(ex["frames"], jex["frames"])
    assert all(len(r.tokens) == 4 for r in got["sched"].completed)
