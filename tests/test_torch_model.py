"""The port's granite-3-8b slice (smoke size) against the reference.

The reference initialises the params; ``params_from_jax`` carries them
over, recomputing the parity with the port's own encoder. Logits agree to
1e-4 (float32 through two layers and the coded head; only summation order
differs), and greedy token streams are identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
from repro.models import TPCtx as JCtx, build as jbuild
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro_torch.configs import get_arch, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import TPCtx, build
from repro_torch.serve import ServeConfig, ServingEngine

T, R = 4, 2
TOL = dict(rtol=1e-4, atol=1e-4)
MASKS = [(True,) * T] + [tuple(i != d for i in range(T)) for d in range(T)]


@pytest.fixture(scope="module")
def pair():
    jcfg = jsmoke(jget_arch("granite-3-8b"))
    jmodel = jbuild(jcfg, JCtx(tp=T, mode="coded", code_r=R))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = smoke_config(get_arch("granite-3-8b"))
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.ctx,
                             device="cpu")
    return jcfg, jmodel, jparams, cfg, model, params


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_config_copy_matches_reference(pair):
    jcfg, _, _, cfg, _, _ = pair
    for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "hd", "norm_eps", "rope_theta", "act"):
        assert getattr(cfg, field) == getattr(jcfg, field), field


def test_parity_leaves_equal(pair):
    _, _, jparams, _, _, params = pair
    tl = dict(_leaves(params))
    n = 0
    for path, leaf in _leaves(jax.tree.map(np.asarray, jparams)):
        np.testing.assert_allclose(tl[path].numpy(), leaf, rtol=1e-5,
                                   atol=1e-6, err_msg=str(path))
        n += path[-1] == "cdc"
    assert n == 6          # wq, wk, wv, w1, w3 (stacked) and the head


def test_encode_tree_shares_base_weights(pair):
    _, _, _, _, model, params = pair
    enc = model.encode_offline(params)
    assert enc["layers"]["ffn"]["w1"]["w"] is params["layers"]["ffn"]["w1"][
        "w"]
    assert enc["lm_head"]["w"] is params["lm_head"]["w"]
    assert enc["embed"] is params["embed"]


@pytest.mark.parametrize("mask", MASKS, ids=lambda m: "".join(
    "1" if v else "0" for v in m))
def test_prefill_and_decode_logits(pair, mask):
    jcfg, jmodel, jparams, cfg, model, params = pair
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    v = np.array(mask)
    jst = jmodel.init_decode(jparams, {"tokens": toks}, 2, 16, jnp.float32,
                             per_row=True)
    jl, jst = jmodel.decode(jparams, jst, jnp.asarray(toks), jnp.asarray(v))
    jl2, _ = jmodel.decode(jparams, jst, jnp.asarray(nxt), jnp.asarray(v))
    st = model.init_decode(params, {"tokens": toks}, 2, 16, torch.float32)
    tl, st = model.decode(params, st, torch.as_tensor(toks), v)
    tl2, _ = model.decode(params, st, torch.as_tensor(nxt), v)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)
    hidden, _ = model.decode(params, model.init_decode(params, {}, 2, 16),
                             torch.as_tensor(toks), v, last_only=True,
                             return_hidden=True)
    assert hidden.shape == (2, 1, cfg.d_model)


@pytest.mark.parametrize("use_fused", [True, False],
                         ids=["fused", "reference"])
def test_generate_with_erasure_matches_reference(pair, use_fused):
    jcfg, jmodel, jparams, cfg, model, params = pair
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)}
    jeng = JEngine(jmodel, jparams, JServeConfig(max_len=24, batch=2,
                                                 cache_dtype=jnp.float32))
    want = jeng.generate(batch, 6, fail_at={2: 1})
    eng = ServingEngine(model, params, ServeConfig(max_len=24, batch=2),
                        use_fused=use_fused)
    got = eng.generate(batch, 6, fail_at={2: 1})
    np.testing.assert_array_equal(got, want)
    assert eng.metrics["erasures_recovered"] == 1
    ex = eng.executor(2)
    assert ex.vstep.use_fused is use_fused
    assert ex.vstep.last_variant == ("fused" if use_fused else "reference")
    # the sequential oracle agrees as well
    eng2 = ServingEngine(model, params, ServeConfig(max_len=24, batch=2))
    np.testing.assert_array_equal(
        eng2._generate_sequential(batch, 6, fail_at={2: 1}), want)


@pytest.mark.parametrize("path", ["grouped-decode", "streaming"])
def test_sdpa_chunked_matches_reference(path):
    """Both attention paths on per-row positions: the grouped one-chunk
    decode path and the streaming online-softmax path (kv chunks shorter
    than the sequence, padded q and kv chunks)."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(2)
    b, sq, sk, hkv, group, hd = 2, 5, 11, 2, 2, 8
    if path == "grouped-decode":
        sq = 1
    q = rng.normal(size=(b, sq, hkv * group, hd)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, hd)).astype(np.float32)
    k_pos = np.stack([np.arange(sk), np.r_[np.arange(sk - 3), [-10 ** 9] * 3]
                      ]).astype(np.int32)
    q_pos = (np.array([[sk - 1], [sk - 4]]) - np.arange(sq)[::-1]) \
        .astype(np.int32)
    kw = dict(kind="causal", window=64, group=group,
              kv_chunk=1024 if path == "grouped-decode" else 4,
              q_chunk=sq if path == "grouped-decode" else 2)
    j = jattn._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(q_pos), jnp.asarray(k_pos), **kw)
    t = tattn._sdpa_chunked(*(torch.from_numpy(a) for a in
                              (q, k, v, q_pos, k_pos)), **kw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_set_code_r_and_heal(pair):
    """Re-sizing r re-encodes parity exactly as the reference does; heal
    restores the mask and re-encodes."""
    from repro.serve import ModelStepper as JStepper
    from repro_torch.serve import ModelStepper
    _, jmodel, jparams, _, model, params = pair
    js = JStepper(jmodel, jparams, max_len=16)
    ts = ModelStepper(model, params, max_len=16)
    assert ts.set_code_r(1) and js.set_code_r(1)
    assert not ts.set_code_r(1)
    assert ts.erasure_budget == js.erasure_budget == 0
    np.testing.assert_allclose(
        ts.params["layers"]["ffn"]["w1"]["cdc"].numpy(),
        np.asarray(js.params["layers"]["ffn"]["w1"]["cdc"]), rtol=1e-5,
        atol=1e-6)
    eng = ServingEngine(model, params, ServeConfig(max_len=24, batch=2))
    eng.inject_failure(3)
    before = eng.params
    eng.heal()
    assert eng.valid.all() and eng.params is not before


def test_generate_twice_reuses_the_executor(pair):
    _, _, _, cfg, model, params = pair
    batch = {"tokens": np.random.default_rng(4).integers(0, cfg.vocab,
                                                         (2, 5))}
    eng = ServingEngine(model, params, ServeConfig(max_len=24, batch=2),
                        use_fused=True)
    first = eng.generate(batch, 4)
    ex = eng.executor(2)
    np.testing.assert_array_equal(eng.generate(batch, 4), first)
    assert eng.executor(2) is ex and eng.metrics["requests"] == 4
