"""The port's hybrid (hymba-1.5b at smoke size: two layers of SWA attention
beside a mamba branch) against the reference.

The reference's executor conformance zoo has no hybrid, so this file
builds the reference side itself: the reference initialises the params
(``encode_offline(init(...))``) and ``params_from_jax`` carries them over,
so both sides hold the same weights; inputs come from numpy seeds. Held
against the JAX package: the config, the causal conv and the mamba branch
(prefill of 1, 37 and 128 tokens, 128 taking the reference's chunked
scan, and a decode step with state; within 1e-5), ``forward`` and
``init_decode`` + ``decode`` (within 1e-4, plain and coded at T = 4, r = 2
folded, under every single dead shard; a padded-head case at 6/3 heads,
run as 8/4), and greedy tokens through the serving engine across the SWA
window, both executors across staggered admission, the chaos scheduler,
``launch.serve`` and the slot helpers (also on xLSTM's state). Also: the
mamba state is written in place, slot isolation on axis 1 for the KV and
the mamba leaves, and the perf counter's reading of the mamba state.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sched import JAX, PORT, build_sched, outcome
from repro import runtime as jruntime
from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
from repro.launch import serve as jserve
from repro.models import TPCtx as JCtx, build as jbuild
from repro.models import mamba as jmamba
from repro.runtime import executor as jexecutor
from repro.serve import ModelStepper as JStepper
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro_torch import runtime as truntime
from repro_torch.configs import all_archs, get_arch, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import TPCtx, build, mamba
from repro_torch.models.attention import attn_dims
from repro_torch.models.common import tree_index
from repro_torch.obs import perf
from repro_torch.runtime import executor as texecutor
from repro_torch.runtime.executor import (SlotPoolExecutor, VStep,
                                          clone_state, read_slot, slot_axis)
from repro_torch.serve import ModelStepper, ServeConfig, ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
MAMBA_TOL = dict(rtol=1e-5, atol=1e-5)
T, R = 4, 2
NAME = "hymba-1.5b"
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
def _pair(mode: str = "coded", **over):
    """(reference model, its params, port model, port params) of hymba at
    smoke size in ``mode``, with the config fields ``over`` replaced; the
    reference's parity re-encoded (``encode_offline(init(...))``)."""
    jcfg = dataclasses.replace(jsmoke(jget_arch(NAME)), **over)
    cfg = dataclasses.replace(smoke_config(get_arch(NAME)), **over)
    jmodel = jbuild(jcfg, JCtx(tp=T, mode=mode, code_r=R, moe_capacity=0))
    jparams = jmodel.encode_offline(jmodel.init(jax.random.PRNGKey(0)))
    model = build(cfg, TPCtx(tp=T, mode=mode, code_r=R))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.ctx,
                             device="cpu")
    return jmodel, jparams, model, params


def _leaves(node, path=()):
    if isinstance(node, dict):
        return {k: v for key, sub in node.items()
                for k, v in _leaves(sub, path + (key,)).items()}
    if isinstance(node, (list, tuple)):
        return {k: v for i, sub in enumerate(node)
                for k, v in _leaves(sub, path + (i,)).items()}
    return {path: node}


def _close(got, want, tol, msg):
    """A port tree against a reference tree, leaf by leaf."""
    g, w = _leaves(got), _leaves(jax.tree.map(np.asarray, want))
    assert set(g) == set(w), msg
    for k in w:
        np.testing.assert_allclose(g[k].numpy(), w[k], **tol,
                                   err_msg=f"{msg}{k}")


# ----------------------------------------------------------- the config ----

def test_config_and_smoke_config_match_reference():
    cfg, jcfg = get_arch(NAME), jget_arch(NAME)
    for full, jfull in ((cfg, jcfg), (smoke_config(cfg), jsmoke(jcfg))):
        for f in dataclasses.fields(full):
            assert getattr(full, f.name) == getattr(jfull, f.name), f.name
    small = smoke_config(cfg)
    assert (small.n_layers, small.d_model, small.n_heads, small.n_kv_heads,
            small.hd, small.d_ff, small.vocab, small.window,
            small.ssm_state) == (2, 128, 4, 2, 32, 256, 512, 64, 8)
    assert NAME in all_archs() and cfg.sub_quadratic
    assert attn_dims(cfg, T) == (28, 7, 4)


def test_params_carry_over_and_parity_is_re_encoded():
    """``params_from_jax`` carries the stacked layers with their mamba
    branch: same keys and shapes; wq, wk, wv, in_proj, w1, w3 and the head
    carry parity (the port's own encode, within 1e-5 of the reference's);
    wbc, out_proj and the raw mamba arrays carry none."""
    _, jparams, _, params = _pair()
    jl, tl = _leaves(jax.tree.map(np.asarray, jparams)), _leaves(params)
    assert set(jl) == set(tl)
    cdc = {k[:-1] for k in tl if k[-1] == "cdc"}
    assert cdc == {("layers", "attn", "wq"), ("layers", "attn", "wk"),
                   ("layers", "attn", "wv"), ("layers", "mamba", "in_proj"),
                   ("layers", "ffn", "w1"), ("layers", "ffn", "w3"),
                   ("lm_head",)}
    assert {k[2] for k in tl if k[:2] == ("layers", "mamba")} == {
        "in_proj", "conv_w", "conv_b", "wbc", "wdt1", "wdt2", "dt_bias",
        "a_log", "d_skip", "out_proj"}
    for k in tl:
        assert tuple(tl[k].shape) == jl[k].shape, k
        np.testing.assert_allclose(tl[k].numpy(), jl[k], rtol=1e-5,
                                   atol=1e-5, err_msg=str(k))


def test_own_init_matches_the_reference_tree():
    """The port's own ``init`` (on the CPU when asked) gives the
    reference's tree: the same paths, shapes and dtypes."""
    jmodel, jparams, model, _ = _pair()
    own = _leaves(model.init(0, device="cpu"))
    ref = _leaves(jax.tree.map(np.asarray, jparams))
    assert set(own) == set(ref)
    for k, v in own.items():
        assert tuple(v.shape) == ref[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(ref[k].dtype), k


# ------------------------------------------------------ the mamba branch ----

@functools.lru_cache(maxsize=None)
def _jmamba(jmodel):
    return jax.jit(lambda p, x, valid, st: jmamba.mamba(
        jmodel.ctx, p, jmodel.cfg, x, valid, st))


@pytest.mark.parametrize("s", [1, 37, 128])
def test_mamba_prefill_and_step_match_reference(s):
    """The causal conv on its own, then the whole branch (coded, shard 1
    dead) on an s-token prefill from zeros (s = 128 takes the reference's
    chunked scan) and a decode step on the state it left: outputs and
    states within 1e-5. Given a state, the port writes the new conv window
    and SSM state into that state's own tensors and returns the same
    dict."""
    jmodel, jparams, model, params = _pair()
    cfg = model.cfg
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["mamba"])
    p = tree_index(params["layers"]["mamba"], 0)
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    st0 = rng.normal(size=(2, mamba.CONV_K - 1, cfg.d_model)).astype(
        np.float32)
    jy, jst = jmamba._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"],
                                  jnp.asarray(st0))
    y, st = mamba._causal_conv(torch.as_tensor(x), p["conv_w"], p["conv_b"],
                               torch.as_tensor(st0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MAMBA_TOL)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    valid = masks()[2]
    jy, jst = _jmamba(jmodel)(jp, jnp.asarray(x), jnp.asarray(valid), None)
    y, st = mamba.mamba(model.ctx, p, cfg, torch.as_tensor(x), valid)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MAMBA_TOL)
    _close(st, jst, MAMBA_TOL, f"prefill s={s} ")
    ptrs = {k: t.data_ptr() for k, t in st.items()}
    jy, jst = _jmamba(jmodel)(jp, jnp.asarray(x1), jnp.asarray(valid), jst)
    y, new = mamba.mamba(model.ctx, p, cfg, torch.as_tensor(x1), valid, st)
    assert new is st and {k: t.data_ptr() for k, t in st.items()} == ptrs
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MAMBA_TOL)
    _close(st, jst, MAMBA_TOL, f"step after s={s} ")


@pytest.mark.parametrize("mode", ["plain", "coded"])
def test_forward_matches_reference(mode):
    """The teacher-forced ``forward`` (logits [B, S, vocab]; S = 70 crosses
    the 64-token smoke window) within 1e-4 of the reference's, plain and
    coded under every single dead shard."""
    jmodel, jparams, model, params = _pair(mode)
    toks = np.random.default_rng(2).integers(0, model.cfg.vocab, (2, 70))
    jfwd = _jit(jmodel, "forward")
    for valid in masks() if mode == "coded" else [None]:
        jv = None if valid is None else jnp.asarray(valid)
        want = np.asarray(jfwd(jparams, {"tokens": jnp.asarray(toks)}, jv))
        got = model.forward(params, {"tokens": toks}, valid)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL,
                                   err_msg=f"mask {valid}")


@functools.lru_cache(maxsize=None)
def _jit(jmodel, method: str):
    """The reference model's ``method``, jitted once per model."""
    return jax.jit(getattr(jmodel, method))


def _decode_steps(jmodel, jparams, model, params, valid, prompt, steps=4):
    """init_decode + the prompt + ``steps - 1`` greedy steps (the
    reference's next token feeds both) on both sides: logits within 1e-4
    at every step and the whole state (KV cache and mamba) at the end;
    every step returns the state object it was given."""
    jv = None if valid is None else jnp.asarray(valid)
    b = prompt.shape[0]
    jst = jmodel.init_decode(jparams, {}, b, 16, jnp.float32, per_row=True)
    st = model.init_decode(params, {}, b, 16)
    ptrs = [t.data_ptr() for t in _leaves(st).values()]
    tok = prompt.astype(np.int32)
    jdecode = _jit(jmodel, "decode")
    for step in range(steps):
        jl, jst = jdecode(jparams, jst, jnp.asarray(tok), jv)
        tl, new = model.decode(params, st, torch.as_tensor(tok), valid)
        assert new is st
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"mask {valid}, step {step}")
        tok = np.asarray(jl)[:, -1:].argmax(-1).astype(np.int32)
    assert [t.data_ptr() for t in _leaves(st).values()] == ptrs
    _close(st, jst, TOL, f"state, mask {valid} ")


@pytest.mark.parametrize("mode", ["plain", "coded"])
def test_init_decode_and_decode_match_reference(mode):
    """A 7-token prefill and 3 decode steps, plain and coded under every
    single dead shard (``_decode_steps``); the mamba state is [L, B, K-1,
    di] and [L, B, di, n], slots on axis 1."""
    jmodel, jparams, model, params = _pair(mode)
    cfg = model.cfg
    st = model.init_decode(params, {}, 2, 16)
    assert st["mamba"]["conv"].shape == (2, 2, mamba.CONV_K - 1, 128)
    assert st["mamba"]["ssm"].shape == (2, 2, 128, cfg.ssm_state)
    assert st["mamba"]["ssm"].dtype == torch.float32
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, (2, 7))
    for valid in masks() if mode == "coded" else [None]:
        _decode_steps(jmodel, jparams, model, params, valid, prompt)


def test_padded_heads_match_reference():
    """6 query heads over 3 KV heads run as 8 over 4 at T = 4 (the
    reference's ``attn_dims``): ``forward`` and ``init_decode`` +
    ``decode`` within 1e-4 under every single dead shard, against the
    reference's re-encoded parity."""
    jmodel, jparams, model, params = _pair(n_heads=6, n_kv_heads=3)
    assert attn_dims(model.cfg, T) == (8, 4, 2)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, model.cfg.vocab, (2, 9))
    jfwd = _jit(jmodel, "forward")
    for valid in masks():
        want = np.asarray(jfwd(jparams, {"tokens": jnp.asarray(toks)},
                               jnp.asarray(valid)))
        np.testing.assert_allclose(
            model.forward(params, {"tokens": toks}, valid).numpy(), want,
            **TOL, err_msg=f"mask {valid}")
        _decode_steps(jmodel, jparams, model, params, valid, toks[:, :5], 3)


# ------------------------------------------------------------- serving ----

@functools.lru_cache(maxsize=None)
def _reference_stream():
    """Two 60-token requests and the reference engine's 10-token streams
    (the 64-entry SWA ring wraps), shard 1 erased at step 3."""
    jmodel, jparams, model, _ = _pair()
    batch = {"tokens": np.random.default_rng(5).integers(
        0, model.cfg.vocab, (2, 60)).astype(np.int32)}
    return batch, JEngine(jmodel, jparams, JServeConfig(
        max_len=80, batch=2, cache_dtype=jnp.float32)).generate(
        batch, 10, fail_at={3: 1})


@pytest.mark.parametrize("use_fused", [True, False],
                         ids=["fused", "reference"])
def test_engine_stream_matches_reference(use_fused):
    """ServingEngine.generate across the SWA window (the ring of 64 wraps
    while the SSM state carries the whole history), shard 1 erased at step
    3: tokens identical to the reference engine's, on the fused round (the
    kernels' plain versions here) and on the reference variant; the
    sequential oracle agrees."""
    _, _, model, params = _pair()
    batch, want = _reference_stream()
    eng = ServingEngine(model, params, ServeConfig(max_len=80, batch=2),
                        use_fused=use_fused)
    assert eng.executor(2).state["kv"]["k"].shape[2] == 64
    np.testing.assert_array_equal(eng.generate(batch, 10, fail_at={3: 1}),
                                  want)
    eng.valid[:] = True
    np.testing.assert_array_equal(
        eng._generate_sequential(batch, 10, fail_at={3: 1}), want)


def _staggered(cfg, n, base_len=4, seed=3):
    """Prompts of different lengths arriving at different times, more
    than the slots: slots are evicted and reused mid-stream."""
    rng = np.random.default_rng(seed)
    return [(i * 1.5, rng.integers(0, cfg.vocab, base_len + i % 3), GEN)
            for i in range(n)]


@pytest.fixture(scope="module")
def steppers():
    jmodel, jparams, model, params = _pair()
    return (JStepper(jmodel, jparams, max_len=48),
            ModelStepper(model, params, max_len=48), model.cfg)


def _run(side, stepper, arrivals, **kw):
    sched = build_sched(side, stepper, **kw)
    done = side.rt.run_arrivals(sched, [tuple(a) for a in arrivals])
    return outcome(sched, done), sched


def _toks(out) -> dict:
    return dict(out["done"])


def test_batched_matches_sequential_and_reference(steppers):
    """Six staggered requests on four slots (eviction and slot reuse): the
    batched executor in both overlap modes, fused and reference rounds,
    and the sequential oracle give identical tokens, equal to the
    reference executor's; ``batched=None`` (the default: auto) takes the
    executor in both packages."""
    jst, st, cfg = steppers
    arrivals = _staggered(cfg, 6)
    want, jsched = _run(JAX, jst, arrivals, n_slots=4)
    assert jsched.rcfg.batched is None and jsched.executor is not None
    runs = {}
    for name, kw in (("sequential", dict(batched=False)),
                     ("auto", dict()),
                     ("sync", dict(overlap=False)),
                     ("auto, reference", dict(use_fused=False))):
        got, sched = _run(PORT, st, arrivals, n_slots=4, **kw)
        assert (sched.executor is None) == (name == "sequential")
        runs[name] = _toks(got)
    assert len(want["done"]) == 6 and all(
        len(t) == GEN for _, t in want["done"])
    for name, toks in runs.items():
        assert toks == _toks(want), name


def test_fused_round_matches_reference_variant(steppers):
    """On a pool at staggered positions, the fused round (body kernels'
    plain versions + the fused head) gives the reference round's tokens,
    fault-free and under every single dead shard, and the reference
    round's logits agree across the masks within 1e-4."""
    _, st, cfg = steppers
    rng = np.random.default_rng(5)
    ex = SlotPoolExecutor(st, 3, overlap=False, use_fused=False)
    for i, plen in enumerate((4, 6, 5)):
        ex.admit(i, rng.integers(0, cfg.vocab, plen), masks()[0], tag=i)
    ref_step, fused_step = VStep(st, use_fused=False), VStep(st,
                                                             use_fused=True)
    assert fused_step.use_fused
    _, _, logits_ok = ref_step.round(clone_state(ex.state),
                                     ex.last_toks.clone(), masks()[0])
    for valid in masks():
        _, toks_ref, logits = ref_step.round(clone_state(ex.state),
                                             ex.last_toks.clone(), valid)
        toks = ex.last_toks.clone()
        _, toks_fused, none = fused_step.round(clone_state(ex.state), toks,
                                               valid)
        assert none is None and toks_fused is toks
        assert torch.equal(toks_fused, toks_ref), valid
        np.testing.assert_allclose(logits.numpy(), logits_ok.numpy(), **TOL)


def test_slot_isolation_on_axis_1(steppers):
    """Admit, evict, fused rounds, a 2MR requeue and re-admission, heal and
    re-encode on a 3-slot pool: the KV cache and the mamba state are
    stacked on axis 1; an admission rewrites its own row with its
    prefill's state and no other; evict, requeue and heal touch no row;
    and in a round every row advances by its own state alone (the same
    round over a state whose other rows are blank leaves it
    bit-identical). Every round leaves the state's own tensors."""
    _, st, cfg = steppers
    assert slot_axis(st.model) == 1
    rng = np.random.default_rng(8)
    ex = SlotPoolExecutor(st, 3, overlap=False, use_fused=True)
    assert ex.slot_axis == 1 and ex.vstep.use_fused
    assert ex.state["mamba"]["ssm"].shape[1] == 3
    ptrs = {k: t.data_ptr() for k, t in _leaves(ex.state).items()}
    full = masks()[0]

    def rows(state):
        return [_leaves(read_slot(state, s, axis=1)) for s in range(3)]

    def same(a, b):
        return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)

    for s in range(3):
        ex.admit(s, rng.integers(0, cfg.vocab, 4 + s), full, tag=s)
    for op, arg in (("round", full), ("evict", 1), ("admit", 1),
                    ("round", masks()[2]), ("requeue", 0), ("admit", 0),
                    ("heal", None), ("round", full), ("admit", 2)):
        before, toks = clone_state(ex.state), ex.last_toks.clone()
        if op == "admit":
            prompt = rng.integers(0, cfg.vocab, 5)
            ex.admit(arg, prompt, full, tag=arg)
            _, row = st.prefill({"tokens": np.asarray(prompt)[None]}, full)
            after = rows(ex.state)
            assert same(after[arg], _leaves(row)), op
            for other in set(range(3)) - {arg}:
                assert same(after[other], rows(before)[other]), (op, other)
            continue
        if op == "round":
            ex.step_round(arg)
        elif op == "heal":
            st.reencode()
        else:                   # evict; requeue: 2MR takes the occupant out
            ex.evict(arg)
            ex.drop_pending()
        after = rows(ex.state)
        for s in range(3):
            if op != "round":
                assert same(after[s], rows(before)[s]), (op, s)
                continue
            alone = clone_state(before)
            for t in _leaves(alone).values():
                keep = t.narrow(1, s, 1).clone()
                t.zero_()
                t.narrow(1, s, 1).copy_(keep)
            ex.vstep.round(alone, toks.clone(), arg)
            assert same(rows(alone)[s], after[s]), (op, s)
    assert {k: t.data_ptr() for k, t in _leaves(ex.state).items()} == ptrs


def test_chaos_scheduler_counters_match_reference(steppers):
    """The scheduler under seeded chaos (mtbf 40 ms, mttr 15 ms, seed 3:
    in-step recoveries, a 2MR requeue and re-admission, re-encodes) over 6
    staggered requests on 4 slots: every request completes, and the
    completions, counters and clock snapshot equal the reference's."""
    jst, st, cfg = steppers
    arrivals = [(i * 2.0, p, GEN) for i, (_, p, _) in
                enumerate(_staggered(cfg, 6))]
    chaos = {"spec": {"mtbf_ms": 40.0, "mttr_ms": 15.0}, "seed": 3}
    want, _ = _run(JAX, jst, arrivals, n_slots=4, chaos=chaos)
    got, _ = _run(PORT, st, arrivals, n_slots=4, chaos=chaos)
    assert got == want
    c = got["counters"]
    assert c["requests_completed"] == 6
    assert c["erasures_recovered"] and c["beyond_budget_failures"]
    assert c["requests_requeued"] and c["parity_reencodes"]


def test_perf_counts_the_mamba_state_by_the_steps_passes():
    """The fused round's counted bytes, at SSM state 16 against 8 (the SSM
    state [L, B, di, n] doubles), grow by the plain step's passes over
    tensors of its size (``mamba.STEP_STATE_PASSES``) plus what grows with n
    outside them (a = -exp(a_log): read, written, read, written, read by
    dt * a; wbc's weight read once; the [B, 1, 2n] projections); never by
    a copy of the state (the cost round runs on clones made before
    counting), and an ``out=`` tensor counts as written, not read."""
    counted, state, extra = [], [], []
    for n in (8, 16):
        cfg = dataclasses.replace(smoke_config(get_arch(NAME)), ssm_state=n)
        model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R))
        params = model.init(0, device="cpu")
        st = ModelStepper(model, params, max_len=24)
        ex = SlotPoolExecutor(st, 4, overlap=False, use_fused=True)
        ex.active[:] = True
        ex.step_round(masks()[0])
        cost = perf.attribute_round_costs(ex.vstep, ex.state,
                                          ex.last_toks)["fused"]
        counted.append(cost.bytes)
        state.append(ex.state["mamba"]["ssm"].numel() * 4)
        lay = params["layers"]["mamba"]
        extra.append(5 * lay["a_log"].numel() * 4
                     + lay["wbc"]["w"].numel() * 4)
    grew = counted[1] - counted[0] - (extra[1] - extra[0])
    d_state = state[1] - state[0]
    assert mamba.STEP_STATE_PASSES * d_state <= grew \
        <= (mamba.STEP_STATE_PASSES + 0.5) * d_state, (grew, d_state)


# ---------------------------------------------------- the slot helpers ----

@pytest.mark.parametrize("name", [NAME, "xlstm-125m"])
def test_slot_helpers_match_reference(name):
    """``supports_slot_batching``, ``stack_states`` and ``unstack_states``
    against the reference's, on the hybrid's decode state (slot axis 1)
    and on xLSTM's (axis 0): three batch-1 states of seeded values,
    stacked and unstacked by both packages, to the bit; unstacking gives
    back the rows."""
    jmodel = jbuild(jsmoke(jget_arch(name)), JCtx(tp=T, mode="coded"))
    model = build(smoke_config(get_arch(name)), TPCtx(tp=T, mode="coded"))
    axis = slot_axis(model)
    assert axis == jexecutor.slot_axis(jmodel) == (1 if name == NAME else 0)
    assert texecutor.supports_slot_batching(model) is \
        jexecutor.supports_slot_batching(jmodel) is True
    rng = np.random.default_rng(9)
    rows, jrows = [], []
    for _ in range(3):
        row = model.empty_decode(1, 24, device="cpu")
        for t in _leaves(row).values():
            t.copy_(torch.as_tensor(rng.integers(-9, 9, t.shape)))
        rows.append(row)
        jrows.append(jax.tree.map(lambda t: jnp.asarray(t.numpy()), row))
    stacked = texecutor.stack_states(rows, axis=axis)
    _close(stacked, jexecutor.stack_states(jrows, axis=axis),
           dict(rtol=0, atol=0), f"{name} stacked ")
    for got, want, row in zip(
            texecutor.unstack_states(stacked, 3, axis=axis),
            jexecutor.unstack_states(
                jexecutor.stack_states(jrows, axis=axis), 3, axis=axis),
            rows):
        _close(got, want, dict(rtol=0, atol=0), f"{name} unstacked ")
        assert all(torch.equal(a, b) for a, b in
                   zip(_leaves(got).values(), _leaves(row).values()))


def test_runtime_config_batched_defaults_to_auto():
    """``RuntimeConfig.batched`` defaults to None (auto) in both packages."""
    assert truntime.RuntimeConfig().batched is None
    assert jruntime.RuntimeConfig().batched is None


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


def test_launch_serve_hymba_completes_with_the_reference_requests(
        monkeypatch, capsys):
    """``launch.serve --arch hymba-1.5b --smoke --coded --device cpu``
    completes every request and hands its scheduler the same prompts, in
    the same order, as the reference's launcher."""
    argv = ["--arch", NAME, "--smoke", "--coded", "--requests", "4",
            "--gen-tokens", "4", "--prompt-len", "5"]
    want = _arrivals_of(monkeypatch, jserve, argv, run_real=False)
    got = _arrivals_of(monkeypatch, tserve, argv + ["--device", "cpu"],
                       run_real=True)
    assert "completed 4/4 requests" in capsys.readouterr().out
    assert len(got["arrivals"]) == len(want["arrivals"]) == 4
    for (t, p, n, ex), (jt, jp, jn, jex) in zip(got["arrivals"],
                                                want["arrivals"]):
        assert (t, n, ex, jex) == (jt, jn, None, None)
        np.testing.assert_array_equal(p, jp)
    assert all(len(r.tokens) == 4 for r in got["sched"].completed)
    assert "mamba" in got["sched"].executor.state
