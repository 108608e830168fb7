"""The port's xLSTM (xlstm-125m, smoke size: an mLSTM and an sLSTM block)
against the reference.

The reference initialises the params and ``params_from_jax`` carries them
over, so both sides hold the same weights; inputs come from numpy seeds.
Held against the JAX package: the config, the chunkwise mLSTM (within the
reference's own 2e-4 of its sequential form, m within 1e-5), each block's
prefill and decode step with state, ``forward`` and ``init_decode`` +
``decode`` (within 1e-4, plain and coded at T = 4, r = 2 folded, under
every single dead shard), and greedy tokens through the serving engine,
both executors across staggered admission, every in-budget erasure, the
chaos scheduler and ``launch.serve``. Also: a decode step writes the
block state in place, slot isolation on axis 0, and the perf counter's
reading of the block state.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sched import JAX, PORT, outcome, build_sched
from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
from repro.launch import serve as jserve
from repro.models import TPCtx as JCtx, build as jbuild
from repro.models import transformer as jtransformer
from repro.models import xlstm as jxlstm
from repro.serve import ModelStepper as JStepper
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro_torch.configs import all_archs, get_arch, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import TPCtx, build, transformer, xlstm
from repro_torch.obs import perf
from repro_torch.runtime.executor import (SlotPoolExecutor, VStep,
                                          clone_state, read_slot, slot_axis)
from repro_torch.serve import ModelStepper, ServeConfig, ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
CHUNK_TOL = dict(rtol=2e-4, atol=2e-4)   # the reference's own, chunkwise
T, R = 4, 2
NAME = "xlstm-125m"
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
def _pair(mode: str = "coded", layout: str = "folded", n_heads: int = 0):
    """(reference model, its params, port model, port params) of xLSTM at
    smoke size in ``mode`` (``n_heads`` replaces the head count)."""
    jcfg, cfg = jsmoke(jget_arch(NAME)), smoke_config(get_arch(NAME))
    if n_heads:
        jcfg = dataclasses.replace(jcfg, n_heads=n_heads)
        cfg = dataclasses.replace(cfg, n_heads=n_heads)
    jmodel = jbuild(jcfg, JCtx(tp=T, mode=mode, code_r=R, code_layout=layout,
                               moe_capacity=0))
    jparams = jmodel.encode_offline(jmodel.init(jax.random.PRNGKey(0)))
    model = build(cfg, TPCtx(tp=T, mode=mode, code_r=R, code_layout=layout))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.ctx,
                             device="cpu")
    return jmodel, jparams, model, params


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, msg):
    """A port tree (dicts, lists, tensors) against a reference tree."""
    if isinstance(want, dict):
        assert set(got) == set(want), msg
        for k in want:
            _close(got[k], want[k], tol, f"{msg}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), msg
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, tol, f"{msg}/{i}")
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol,
                                   err_msg=msg)


# ----------------------------------------------------------- the config ----

def test_config_and_smoke_config_match_reference():
    cfg, jcfg = get_arch(NAME), jget_arch(NAME)
    for full, jfull in ((cfg, jcfg), (smoke_config(cfg), jsmoke(jcfg))):
        for f in dataclasses.fields(full):
            assert getattr(full, f.name) == getattr(jfull, f.name), f.name
        assert transformer.xlstm_block_kinds(full) == \
            jtransformer.xlstm_block_kinds(jfull)
    small = smoke_config(cfg)
    assert (small.n_layers, small.d_model, small.n_heads, small.vocab,
            small.slstm_every) == (2, 128, 4, 512, 2)
    assert transformer.xlstm_block_kinds(small) == ["mlstm", "slstm"]
    assert transformer.xlstm_block_kinds(cfg) == \
        ["mlstm"] * 7 + ["slstm"] + ["mlstm"] * 4
    assert NAME in all_archs() and cfg.sub_quadratic


def test_params_carry_over_and_parity_is_re_encoded():
    """``params_from_jax`` walks the ``blocks`` list: same keys and shapes;
    up, wq, wk, wv, wx and the head carry parity (the port's own encode,
    within 1e-5 of the reference's); down, wif and r carry none."""
    _, jparams, _, params = _pair()

    def leaves(node, path=()):
        if isinstance(node, dict):
            return {k: v for key, sub in node.items()
                    for k, v in leaves(sub, path + (key,)).items()}
        if isinstance(node, (list, tuple)):
            return {k: v for i, sub in enumerate(node)
                    for k, v in leaves(sub, path + (i,)).items()}
        return {path: node}

    jl, tl = leaves(_np(jparams)), leaves(params)
    assert set(jl) == set(tl)
    assert isinstance(params["blocks"], list) and len(params["blocks"]) == 2
    cdc = {k[:-1] for k in tl if k[-1] == "cdc"}
    assert cdc == {("blocks", 0, "up"), ("blocks", 0, "wq"),
                   ("blocks", 0, "wk"), ("blocks", 0, "wv"),
                   ("blocks", 1, "wx"), ("lm_head",)}
    for k in tl:
        assert tuple(tl[k].shape) == jl[k].shape, k
        np.testing.assert_allclose(tl[k].numpy(), jl[k], rtol=1e-5,
                                   atol=1e-5, err_msg=str(k))


# ------------------------------------------------------ the recurrences ----

def _gates(rng, b, s, nh, dh):
    q = rng.normal(size=(b, s, nh, dh)).astype(np.float32)
    k = (rng.normal(size=(b, s, nh, dh)) / dh ** 0.5).astype(np.float32)
    v = rng.normal(size=(b, s, nh, dh)).astype(np.float32)
    i_raw = rng.normal(size=(b, s, nh)).astype(np.float32)
    f_log = np.asarray(-jax.nn.softplus(
        -jnp.asarray(rng.normal(size=(b, s, nh)), jnp.float32) - 1.0))
    return q, k, v, i_raw, f_log


@pytest.mark.parametrize("s,chunk", [(70, 16), (300, 128)])
def test_mlstm_chunkwise_matches_reference(s, chunk):
    """The chunkwise form (the last chunk padded: 70 = 4 x 16 + 6, 300 = 2
    x 128 + 44) against the reference's chunkwise form and the port's own
    sequential step run s times: h and C within the reference's 2e-4, m
    within 1e-5."""
    b, nh, dh = 2, 3, 8
    xs = _gates(np.random.default_rng(s), b, s, nh, dh)
    c0 = np.zeros((b, nh, dh, dh), np.float32)
    n0 = np.zeros((b, nh, dh), np.float32)
    m0 = np.full((b, nh), -1e30, np.float32)
    jh, jst = jax.jit(functools.partial(jxlstm._mlstm_chunkwise,
                                        chunk=chunk))(
        *map(jnp.asarray, xs + (c0, n0, m0)))
    th, tst = xlstm._mlstm_chunkwise(
        *map(torch.tensor, xs + (c0, n0, m0)), chunk=chunk)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **CHUNK_TOL)
    for got, want, tol in zip(tst, jst, (CHUNK_TOL, CHUNK_TOL,
                                         dict(rtol=1e-5, atol=1e-5))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    # the sequential form, one step at a time on a state in place
    st = {"c": torch.as_tensor(c0), "n": torch.as_tensor(n0),
          "m": torch.as_tensor(m0)}
    q, k, v, i, f = map(torch.tensor, xs)
    hs = torch.stack([xlstm._mlstm_step(st, q[:, t], k[:, t], v[:, t],
                                        i[:, t], f[:, t])
                      for t in range(s)], dim=1)
    np.testing.assert_allclose(th.numpy(), hs.numpy(), **CHUNK_TOL)
    np.testing.assert_allclose(tst[0].numpy(), st["c"].numpy(), **CHUNK_TOL)
    np.testing.assert_allclose(tst[2].numpy(), st["m"].numpy(), rtol=1e-5,
                               atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jblock(jmodel, kind):
    fn = jxlstm.mlstm if kind == "mlstm" else jxlstm.slstm
    return jax.jit(lambda p, x, valid, st: fn(jmodel.ctx, p, jmodel.cfg, x,
                                              valid, st))


@pytest.mark.parametrize("mode", ["plain", "coded"])
def test_blocks_prefill_and_step_match_reference(mode):
    """Each block (mLSTM, sLSTM) on a 6-token prompt from its initial
    state, then one decode step on the state it left: outputs and states
    within 1e-4 of the reference's, plain and coded under every single
    dead shard. Given a state, the port's block writes it in place and
    returns the same dict."""
    jmodel, jparams, model, params = _pair(mode)
    cfg = model.cfg
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    inits = {"mlstm": (jxlstm.init_mlstm_state, xlstm.init_mlstm_state),
             "slstm": (jxlstm.init_slstm_state, xlstm.init_slstm_state)}
    fns = {"mlstm": xlstm.mlstm, "slstm": xlstm.slstm}
    for i, kind in enumerate(transformer.xlstm_block_kinds(cfg)):
        jfn = _jblock(jmodel, kind)
        for valid in masks() if mode == "coded" else [None]:
            jv = None if valid is None else jnp.asarray(valid)
            jst = inits[kind][0](jmodel.cfg, 2)
            st = inits[kind][1](cfg, 2)
            for step, inp in (("prefill", x), ("step", x1)):
                jy, jst = jfn(jparams["blocks"][i], jnp.asarray(inp), jv, jst)
                y, new = fns[kind](model.ctx, params["blocks"][i], cfg,
                                   torch.as_tensor(inp), valid, st)
                assert new is st
                msg = f"{kind} {step}, mask {valid}"
                np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL,
                                           err_msg=msg)
                _close(st, jst, TOL, msg)


@pytest.mark.parametrize("mode", ["plain", "coded"])
def test_forward_matches_reference(mode):
    """The teacher-forced ``forward`` (logits [B, S, vocab]) within 1e-4
    of the reference's, plain and coded under every single dead shard."""
    jmodel, jparams, model, params = _pair(mode)
    toks = np.random.default_rng(2).integers(0, model.cfg.vocab, (2, 9))
    jfwd = jax.jit(jmodel.forward)
    for valid in masks() if mode == "coded" else [None]:
        jv = None if valid is None else jnp.asarray(valid)
        want = np.asarray(jfwd(jparams, {"tokens": jnp.asarray(toks)}, jv))
        got = model.forward(params, {"tokens": toks}, valid)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL,
                                   err_msg=f"mask {valid}")


@pytest.mark.parametrize("mode", ["plain", "coded"])
def test_init_decode_and_decode_match_reference(mode):
    """init_decode + a 7-token prefill + 3 decode steps (the reference's
    next token feeds both): logits within 1e-4 at every step and the
    block states at the end, plain and coded under every single dead
    shard; every step returns the state object it was given."""
    jmodel, jparams, model, params = _pair(mode)
    cfg = model.cfg
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, (2, 7))
    jdecode = jax.jit(jmodel.decode)
    for valid in masks() if mode == "coded" else [None]:
        jv = None if valid is None else jnp.asarray(valid)
        jst = jmodel.init_decode(jparams, {}, 2, 16, jnp.float32,
                                 per_row=True)
        st = model.init_decode(params, {}, 2, 16)
        assert (st["blocks"][0]["m"] == np.float32(-1e30)).all()
        tok = prompt.astype(np.int32)
        for step in range(4):
            jl, jst = jdecode(jparams, jst, jnp.asarray(tok), jv)
            tl, new = model.decode(params, st, torch.as_tensor(tok), valid)
            assert new is st
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                       err_msg=f"mask {valid}, step {step}")
            tok = np.asarray(jl)[:, -1:].argmax(-1).astype(np.int32)
        _close(st, jst, TOL, f"state, mask {valid}")


# ------------------------------------------------------------- serving ----

@functools.lru_cache(maxsize=None)
def _reference_stream():
    """Two requests and the reference engine's 8-token streams, shard 1
    erased at step 3."""
    jmodel, jparams, model, _ = _pair()
    batch = {"tokens": np.random.default_rng(5).integers(
        0, model.cfg.vocab, (2, 7)).astype(np.int32)}
    return batch, JEngine(jmodel, jparams, JServeConfig(
        max_len=24, batch=2, cache_dtype=jnp.float32)).generate(
        batch, 8, fail_at={3: 1})


@pytest.mark.parametrize("use_fused", [True, False],
                         ids=["fused", "reference"])
def test_engine_stream_matches_reference(use_fused):
    """ServingEngine.generate, shard 1 erased at step 3: tokens identical
    to the reference engine's, on the fused round (the kernels' plain
    versions here) and on the reference variant; the sequential oracle
    agrees."""
    _, _, model, params = _pair()
    batch, want = _reference_stream()
    eng = ServingEngine(model, params, ServeConfig(max_len=24, batch=2),
                        use_fused=use_fused)
    np.testing.assert_array_equal(eng.generate(batch, 8, fail_at={3: 1}),
                                  want)
    eng.valid[:] = True
    np.testing.assert_array_equal(
        eng._generate_sequential(batch, 8, fail_at={3: 1}), want)


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
    reference executor's."""
    jst, st, cfg = steppers
    arrivals = _staggered(cfg, 6)
    want, _ = _run(JAX, jst, arrivals, n_slots=4)
    runs = {}
    for name, kw in (("sequential", dict(batched=False)),
                     ("overlap", dict(overlap=True)),
                     ("sync", dict(overlap=False)),
                     ("overlap, reference", dict(overlap=True,
                                                 use_fused=False))):
        got, sched = _run(PORT, st, arrivals, n_slots=4, **kw)
        assert (sched.executor is None) == (name == "sequential")
        runs[name] = _toks(got)
    assert len(want["done"]) == 6 and all(
        len(t) == GEN for _, t in want["done"])
    for name, toks in runs.items():
        assert toks == _toks(want), name


def test_every_inbudget_erasure_gives_the_same_tokens(steppers):
    """For every shard index, an erasure at 2 ms is recovered in-step:
    the stream equals the fault-free one, nothing is requeued; the
    reference's stream under shard 1 agrees."""
    jst, st, cfg = steppers
    arrivals = _staggered(cfg, 4)
    ok, _ = _run(PORT, st, arrivals, n_slots=4)
    for shard in range(T):
        got, _ = _run(PORT, st, arrivals, n_slots=4,
                      events=[("erasure", 2.0, shard)])
        assert _toks(got) == _toks(ok), f"shard {shard}"
        assert got["counters"]["erasures_recovered"] == 1
        assert got["counters"]["requests_requeued"] == 0
    want, _ = _run(JAX, jst, arrivals, n_slots=4,
                   events=[("erasure", 2.0, 1)])
    assert _toks(want) == _toks(ok)


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


def test_slot_isolation_on_axis_0(steppers):
    """Admit, evict, fused rounds, a 2MR requeue and re-admission, heal and
    re-encode on a 3-slot pool: the block state is stacked on axis 0; an
    admission rewrites its own row with its prefill's state and no other;
    evict, requeue and heal touch no row; and in a round every row
    advances by its own recurrence alone (the same round over a state
    whose other rows are blank leaves it bit-identical)."""
    _, st, cfg = steppers
    assert slot_axis(st.model) == 0
    rng = np.random.default_rng(8)
    ex = SlotPoolExecutor(st, 3, overlap=False, use_fused=True)
    assert ex.slot_axis == 0 and ex.vstep.use_fused
    assert ex.state["blocks"][0]["c"].shape[0] == 3
    full = masks()[0]

    def rows(state):
        return [read_slot(state, s, axis=0) for s in range(3)]

    def same(a, b):
        return all(torch.equal(x, y)
                   for ba, bb in zip(a["blocks"], b["blocks"])
                   for x, y in zip(ba.values(), bb.values()))

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
            assert same(after[arg], row), op
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
            for blk in alone["blocks"]:
                for t in blk.values():
                    keep = t[s].clone()
                    t.zero_()
                    t[s] = keep
            ex.vstep.round(alone, toks.clone(), arg)
            assert same(rows(alone)[s], after[s]), (op, s)


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
    got, sched = _run(PORT, st, arrivals, n_slots=4, chaos=chaos)
    assert got == want
    c = got["counters"]
    assert c["requests_completed"] == 6
    assert c["erasures_recovered"] and c["beyond_budget_failures"]
    assert c["requests_requeued"] and c["parity_reencodes"]


def test_perf_counts_the_block_state_by_the_steps_passes():
    """The fused round's counted bytes, at 2 heads against 4 (the mLSTM
    memory [B, nh, dh, dh] doubles; dh = 2d / nh), grow by the mLSTM
    step's passes over its memory (read for the scale and the rank-1
    write, written by both, read for the readout: 5) plus what the
    sLSTM's recurrence and the per-head gates add; never by a copy of the
    state (the cost round runs on clones made before counting)."""
    counted, memory = [], []
    for n_heads in (4, 2):
        _, _, model, params = _pair(n_heads=n_heads)
        st = ModelStepper(model, params, max_len=24)
        ex = SlotPoolExecutor(st, 4, overlap=False, use_fused=True)
        ex.active[:] = True
        ex.step_round(masks()[0])
        cost = perf.attribute_round_costs(ex.vstep, ex.state,
                                          ex.last_toks)["fused"]
        counted.append(cost.bytes)
        blocks = ex.state["blocks"]
        memory.append(blocks[0]["c"].numel() * 4)
    grew, mem_grew = counted[1] - counted[0], memory[1] - memory[0]
    assert 5 * mem_grew <= grew <= 5.5 * mem_grew, (grew, mem_grew)


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


def test_launch_serve_xlstm_completes_with_the_reference_requests(
        monkeypatch, capsys):
    """``launch.serve --arch xlstm-125m --smoke --coded --device cpu``
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
