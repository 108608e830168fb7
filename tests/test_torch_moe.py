"""The port's mixtures of experts (qwen2-moe-a2.7b and qwen3-moe-235b-a22b
at smoke size: two layers of 8 routed experts, top-2, qwen2's beside one
coded shared expert) against the reference.

The reference initialises the params (``encode_offline(init(...))``) and
``params_from_jax`` carries them over, so both sides hold the same
weights; inputs come from numpy seeds. Held against the JAX package: the
configs and their smoke configs, ``_pad_experts``, the param tree,
``_route``'s six outputs (capacity 0 and 1.25, with a planted row of
equal logits), ``moe`` (capacity 0, and 1.25 with drops; within 1e-5),
``moe_aux_loss``, ``forward`` and ``init_decode`` + ``decode`` (within
1e-4, plain and coded at T = 4, r = 2 folded, under every single dead
shard; qwen3 also with a query wider than d), greedy streams through the
serving engine, both executors and the chaos scheduler, and
``launch.serve``. Also: the combine is a fixed-order sum (two calls equal
to the bit), and the port's own init gives the reference's tree.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sched import JAX, PORT, build_sched, outcome
from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
from repro.launch import serve as jserve
from repro.models import TPCtx as JCtx, build as jbuild
from repro.models import ffn as jffn
from repro.serve import ModelStepper as JStepper
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro_torch.configs import all_archs, get_arch, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import TPCtx, build, ffn
from repro_torch.models.attention import attn_dims
from repro_torch.runtime.executor import SlotPoolExecutor, VStep, clone_state
from repro_torch.serve import ModelStepper, ServeConfig, ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
T, R = 4, 2
QWEN2, QWEN3 = "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"
GEN = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's smoke-size ops: the suite runs
    in several worker processes at once, and their thread pools would
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def masks():
    """The all-valid mask and every single dead shard."""
    return [np.ones(T, bool)] + [np.arange(T) != d for d in range(T)]


@functools.lru_cache(maxsize=None)
def _pair(name: str, mode: str = "coded", capacity: float = 0, **over):
    """(reference model, its params, port model, port params) of ``name``
    at smoke size in ``mode`` at MoE capacity ``capacity``, with the
    config fields ``over`` replaced; the reference's parity re-encoded
    (``encode_offline(init(...))``)."""
    jcfg = dataclasses.replace(jsmoke(jget_arch(name)), **over)
    cfg = dataclasses.replace(smoke_config(get_arch(name)), **over)
    jmodel = jbuild(jcfg, JCtx(tp=T, mode=mode, code_r=R,
                               moe_capacity=capacity))
    jparams = jmodel.encode_offline(jmodel.init(jax.random.PRNGKey(0)))
    model = build(cfg, TPCtx(tp=T, mode=mode, code_r=R,
                             moe_capacity=capacity))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.ctx,
                             device="cpu")
    return jmodel, jparams, model, params


def _leaves(node, path=()):
    if isinstance(node, dict):
        return {k: v for key, sub in node.items()
                for k, v in _leaves(sub, path + (key,)).items()}
    return {path: node}


def _layer(tree, i: int = 0):
    """Layer ``i`` of the stacked MoE params (numpy or torch leaves)."""
    return jax.tree.map(lambda a: a[i], tree)


# ---------------------------------------------------------- the configs ----

@pytest.mark.parametrize("name", [QWEN2, QWEN3])
def test_configs_and_smoke_configs_match_reference(name):
    """Every field of the config and of its smoke config equals the
    reference's; the smoke config reduces the MoE fields as the
    reference's does (8 experts, top-2, at most one shared expert of
    64)."""
    cfg, jcfg = get_arch(name), jget_arch(name)
    for full, jfull in ((cfg, jcfg), (smoke_config(cfg), jsmoke(jcfg))):
        for f in dataclasses.fields(full):
            assert getattr(full, f.name) == getattr(jfull, f.name), f.name
    small = smoke_config(cfg)
    assert (small.n_experts, small.top_k, small.d_ff_expert) == (8, 2, 64)
    assert small.n_shared_experts == (1 if name == QWEN2 else 0)
    assert name in all_archs() and cfg.family == "moe"


@pytest.mark.parametrize("n,tp", [(60, 4), (60, 12), (60, 16), (128, 16),
                                  (8, 3)])
def test_pad_experts_matches_reference(n, tp):
    got = ffn._pad_experts(n, tp)
    assert got == jffn._pad_experts(n, tp) and got % tp == 0 and got >= n
    assert ffn._pad_experts(60, 4) == 60 and ffn._pad_experts(60, 16) == 64


@pytest.mark.parametrize("name", [QWEN2, QWEN3])
def test_params_carry_over_and_own_init_matches_the_reference_tree(name):
    """``params_from_jax`` carries the MoE tree: the same paths, shapes
    and values; the router and the experts raw (no parity), the shared
    experts' w1/w3 (qwen2) re-encoded by the port within 1e-5 of the
    reference's parity. The port's own ``init`` (on the CPU when asked)
    gives the same paths, shapes and dtypes, and 12 experts at T = 16
    (60 -> 64 at full size)."""
    jmodel, jparams, model, params = _pair(name)
    jl, tl = _leaves(jax.tree.map(np.asarray, jparams)), _leaves(params)
    assert set(jl) == set(tl)
    cdc = {k[:-1] for k in tl if k[-1] == "cdc"}
    want = {("layers", "attn", n) for n in ("wq", "wk", "wv")} | {
        ("lm_head",)}
    if name == QWEN2:
        want |= {("layers", "moe", "shared", "w1"),
                 ("layers", "moe", "shared", "w3")}
    assert cdc == want
    assert {k[2] for k in tl if k[:2] == ("layers", "moe")} == (
        {"router", "we1", "we3", "we2"}
        | ({"shared"} if name == QWEN2 else set()))
    assert "ffn" not in params["layers"]
    e, cfg = 8, model.cfg
    assert tuple(tl[("layers", "moe", "we1")].shape) == (2, e, 128, 64)
    assert tuple(tl[("layers", "moe", "we2")].shape) == (2, e, 64, 128)
    assert tuple(tl[("layers", "moe", "router", "w")].shape) == (2, 128, e)
    for k in tl:
        assert tuple(tl[k].shape) == jl[k].shape, k
        np.testing.assert_allclose(tl[k].numpy(), jl[k], rtol=1e-5,
                                   atol=1e-5, err_msg=str(k))
    own = _leaves(model.init(0, device="cpu"))
    assert set(own) == set(jl)
    for k, v in own.items():
        assert tuple(v.shape) == jl[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(jl[k].dtype), k
    wide = build(dataclasses.replace(cfg, n_experts=12), TPCtx(tp=16))
    assert wide.init(0, device="cpu")["layers"]["moe"]["we1"].shape[1] == 16


# --------------------------------------------------------------- the MoE ----

def _tokens(seed: int, n: int, d: int, zero_row: int | None = None):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    if zero_row is not None:
        x[zero_row] = 0.0          # equal logits: top-k ties everywhere
    return x


@pytest.mark.parametrize("capacity", [0, 1.25])
def test_route_matches_reference(capacity):
    """``_route``'s six outputs at capacity 0 (cap = n·k) and 1.25 (cap
    from all n·k routed pairs): experts, tokens, positions, keep and cap
    equal; gates within 1e-5. Token 3's row is zero, so its 8 logits are
    equal: the port's top-k takes the lowest indices, as
    ``lax.top_k`` does."""
    jmodel, jparams, model, params = _pair(QWEN2, capacity=capacity)
    jw = jparams["layers"]["moe"]["router"]["w"][0]
    w = params["layers"]["moe"]["router"]["w"][0]
    x = _tokens(7, 21, model.cfg.d_model, zero_row=3)
    want = jffn._route(jmodel.ctx, jw, jnp.asarray(x), 2, 8)
    got = ffn._route(model.ctx, w, torch.as_tensor(x), 2, 8)
    assert got[5] == want[5] == (int(1.25 * 42 / 8) if capacity else 42)
    for i, name in enumerate(("se", "sg", "st", "pos", "keep")):
        if name == "sg":
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                       **MOE_TOL)
        else:
            np.testing.assert_array_equal(got[i].numpy(),
                                          np.asarray(want[i]), name)
    tied = got[0][got[2] == 3]
    assert sorted(tied.tolist()) == [0, 1]
    assert bool(got[4].all()) == (capacity == 0)


@pytest.mark.parametrize("name,capacity", [(QWEN2, 0), (QWEN2, 1.25),
                                           (QWEN3, 0), (QWEN3, 1.25)])
def test_moe_matches_reference(name, capacity):
    """``moe`` over [3, 11, d] (with a zero token) within 1e-5 of the
    reference's: at capacity 0 every routed pair is kept; at 1.25 some
    are dropped (the kept ones fill each expert's first cap slots) and
    the two packages still agree. qwen2 adds the coded shared experts,
    here under a dead shard."""
    jmodel, jparams, model, params = _pair(name, capacity=capacity)
    jp, p = _layer(jparams["layers"]["moe"]), _layer(params["layers"]["moe"])
    x = _tokens(11, 33, model.cfg.d_model, zero_row=5).reshape(3, 11, -1)
    valid = masks()[2]
    want = np.asarray(jffn.moe(jmodel.ctx, jp, jmodel.cfg, jnp.asarray(x),
                               jnp.asarray(valid)))
    got = ffn.moe(model.ctx, p, model.cfg, torch.as_tensor(x), valid)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **MOE_TOL)
    keep = ffn._route(model.ctx, p["router"]["w"],
                      torch.as_tensor(x.reshape(33, -1)), 2, 8)[4]
    assert bool(keep.all()) == (capacity == 0)


def test_combine_is_a_fixed_order_sum():
    """Two calls of the routed path on the same input are equal to the
    bit (the combine sums each token's k contributions through a stable
    sort, no scatter-add), and a token's output does not depend on which
    other tokens share the call at capacity 0."""
    _, _, model, params = _pair(QWEN3)
    p = _layer(params["layers"]["moe"])
    x = torch.as_tensor(_tokens(13, 24, model.cfg.d_model))
    a = ffn._moe_local(model.ctx, p, x, 8, 2)
    b = ffn._moe_local(model.ctx, p, x.clone(), 8, 2)
    assert torch.equal(a, b)
    alone = ffn._moe_local(model.ctx, p, x[5:6], 8, 2)
    torch.testing.assert_close(alone, a[5:6], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", [QWEN2, QWEN3])
def test_moe_aux_loss_matches_reference(name):
    jmodel, jparams, model, params = _pair(name)
    jp, p = _layer(jparams["layers"]["moe"]), _layer(params["layers"]["moe"])
    x = _tokens(17, 40, model.cfg.d_model, zero_row=0).reshape(4, 10, -1)
    want = float(jffn.moe_aux_loss(jp, jmodel.cfg, jnp.asarray(x)))
    got = ffn.moe_aux_loss(p, model.cfg, torch.as_tensor(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, **MOE_TOL)


# ------------------------------------------------ forward and decode ----

@functools.lru_cache(maxsize=None)
def _jit(jmodel, method: str):
    return jax.jit(getattr(jmodel, method))


def _decode_steps(jmodel, jparams, model, params, valid, prompt, steps=3):
    """init_decode + the prompt + ``steps - 1`` greedy steps on both sides
    (the reference's next token feeds both): logits within 1e-4 at every
    step and the KV cache at the end; the decode state is the KV cache
    alone."""
    jv = None if valid is None else jnp.asarray(valid)
    b = prompt.shape[0]
    jst = jmodel.init_decode(jparams, {}, b, 16, jnp.float32, per_row=True)
    st = model.init_decode(params, {}, b, 16)
    assert set(st) == {"kv"}
    tok = prompt.astype(np.int32)
    jdecode = _jit(jmodel, "decode")
    for step in range(steps):
        jl, jst = jdecode(jparams, jst, jnp.asarray(tok), jv)
        tl, st = model.decode(params, st, torch.as_tensor(tok), valid)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"mask {valid}, step {step}")
        tok = np.asarray(jl)[:, -1:].argmax(-1).astype(np.int32)
    for k in ("k", "v", "pos", "len"):
        np.testing.assert_allclose(st["kv"][k].numpy(),
                                   np.asarray(jst["kv"][k]), **TOL)


@pytest.mark.parametrize("name,mode,over", [
    (QWEN2, "plain", ()), (QWEN2, "coded", ()), (QWEN3, "plain", ()),
    (QWEN3, "coded", ()), (QWEN3, "coded", (("head_dim", 64),))],
    ids=["qwen2-plain", "qwen2-coded", "qwen3-plain", "qwen3-coded",
         "qwen3-hd64-coded"])
def test_forward_and_decode_match_reference(name, mode, over):
    """``forward`` (logits [2, 9, vocab]) and a 6-token prefill with 2
    decode steps within 1e-4 of the reference's, plain, or coded under
    every single dead shard. qwen3 with 64-wide heads runs a query of 4 x
    64 = 256 against d = 128 (its full size: 64 x 128 against 4096)."""
    jmodel, jparams, model, params = _pair(name, mode, **dict(over))
    if over:
        hq, hkv, _ = attn_dims(model.cfg, T)
        assert hq * model.cfg.hd == 2 * model.cfg.d_model
    rng = np.random.default_rng(2)
    toks = rng.integers(0, model.cfg.vocab, (2, 9))
    jfwd = _jit(jmodel, "forward")
    for valid in masks() if mode == "coded" else [None]:
        jv = None if valid is None else jnp.asarray(valid)
        want = np.asarray(jfwd(jparams, {"tokens": jnp.asarray(toks)}, jv))
        got = model.forward(params, {"tokens": toks}, valid)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL,
                                   err_msg=f"mask {valid}")
        _decode_steps(jmodel, jparams, model, params, valid, toks[:, :6])


# ------------------------------------------------------------- serving ----

@functools.lru_cache(maxsize=None)
def _reference_stream():
    """Two 12-token requests and the reference engine's 8-token streams,
    shard 1 erased at step 3."""
    jmodel, jparams, model, _ = _pair(QWEN2)
    batch = {"tokens": np.random.default_rng(5).integers(
        0, model.cfg.vocab, (2, 12)).astype(np.int32)}
    return batch, JEngine(jmodel, jparams, JServeConfig(
        max_len=24, batch=2, cache_dtype=jnp.float32)).generate(
        batch, 8, fail_at={3: 1})


@pytest.mark.parametrize("use_fused", [True, False],
                         ids=["fused", "reference"])
def test_engine_stream_matches_reference(use_fused):
    """ServingEngine.generate with shard 1 erased at step 3: tokens
    identical to the reference engine's on the fused round (the kernels'
    plain versions here) and on the reference variant; the sequential
    oracle agrees."""
    _, _, model, params = _pair(QWEN2)
    batch, want = _reference_stream()
    eng = ServingEngine(model, params, ServeConfig(max_len=24, batch=2),
                        use_fused=use_fused)
    np.testing.assert_array_equal(eng.generate(batch, 8, fail_at={3: 1}),
                                  want)
    eng.valid[:] = True
    np.testing.assert_array_equal(
        eng._generate_sequential(batch, 8, fail_at={3: 1}), want)


@pytest.fixture(scope="module")
def steppers():
    jmodel, jparams, model, params = _pair(QWEN2)
    return (JStepper(jmodel, jparams, max_len=32),
            ModelStepper(model, params, max_len=32), model.cfg)


def _staggered(cfg, n, base_len=4, seed=3):
    """Prompts of different lengths arriving at different times, more
    than the slots: slots are evicted and reused mid-stream."""
    rng = np.random.default_rng(seed)
    return [(i * 1.5, rng.integers(0, cfg.vocab, base_len + i % 3), GEN)
            for i in range(n)]


def _run(side, stepper, arrivals, **kw):
    sched = build_sched(side, stepper, **kw)
    done = side.rt.run_arrivals(sched, [tuple(a) for a in arrivals])
    return outcome(sched, done), sched


def test_batched_matches_sequential_and_reference(steppers):
    """Six staggered requests on four slots: the batched executor (fused
    and reference rounds) and the sequential oracle give identical
    tokens, equal to the reference executor's. At capacity 0 a slot's
    routing does not depend on the other slots, so batching changes no
    token."""
    jst, st, cfg = steppers
    arrivals = _staggered(cfg, 6)
    want, _ = _run(JAX, jst, arrivals, n_slots=4)
    assert len(want["done"]) == 6
    for kw in (dict(batched=False), dict(), dict(use_fused=False)):
        got, sched = _run(PORT, st, arrivals, n_slots=4, **kw)
        assert (sched.executor is None) == (kw == dict(batched=False))
        assert dict(got["done"]) == dict(want["done"]), kw


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
        _, toks_fused, none = fused_step.round(clone_state(ex.state),
                                               ex.last_toks.clone(), valid)
        assert none is None and torch.equal(toks_fused, toks_ref), valid
        np.testing.assert_allclose(logits.numpy(), logits_ok.numpy(), **TOL)


def test_chaos_scheduler_counters_match_reference(steppers):
    """The scheduler under seeded chaos (mtbf 40 ms, mttr 15 ms, seed 3)
    over 6 staggered requests on 4 slots: every request completes, and
    the completions, counters and clock snapshot equal the
    reference's."""
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


def test_launch_serve_qwen2_moe_completes_with_the_reference_requests(
        monkeypatch, capsys):
    """``launch.serve --arch qwen2-moe-a2.7b --smoke --coded --device
    cpu`` builds the model at capacity 0, as the reference's launcher
    does, completes every request and hands its scheduler the same
    prompts, in the same order, as the reference's launcher."""
    argv = ["--arch", QWEN2, "--smoke", "--coded", "--requests", "4",
            "--gen-tokens", "4", "--prompt-len", "5"]
    want = _arrivals_of(monkeypatch, jserve, argv, run_real=False)
    got = _arrivals_of(monkeypatch, tserve, argv + ["--device", "cpu"],
                       run_real=True)
    assert "completed 4/4 requests" in capsys.readouterr().out
    assert got["sched"].stepper.model.ctx.moe_capacity == 0
    assert want["sched"].stepper.model.ctx.moe_capacity == 0
    assert len(got["arrivals"]) == len(want["arrivals"]) == 4
    for (t, p, n, ex), (jt, jp, jn, jex) in zip(got["arrivals"],
                                                want["arrivals"]):
        assert (t, n, ex, jex) == (jt, jn, None, None)
        np.testing.assert_array_equal(p, jp)
    assert all(len(r.tokens) == 4 for r in got["sched"].completed)
    assert set(got["sched"].executor.state) == {"kv"}
