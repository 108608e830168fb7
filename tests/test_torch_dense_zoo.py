"""The rest of the port's dense decoders (smoke size) against the reference.

The configs the port registers, ``Model.forward`` (teacher-forced logits),
granite at code widths whose heads need padding (T = 3: 6/2 heads, T =
12: 12/2), and h2o-danube-1.8b's sliding window crossed by a greedy
stream. The reference initialises the params and ``params_from_jax``
carries them over, recomputing the parity with the port's own encoder.
The reference side runs on ``encode_offline(init(...))``: its ``init``
zeroes the padded head columns after encoding their parity, so its own
parity leaves are stale at padded widths (ROADMAP, reference caveats).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
from repro.models import TPCtx as JCtx, build as jbuild
from repro.models.attention import attn_dims as jattn_dims
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro_torch.configs import PORT_ONLY, all_archs, get_arch, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import TPCtx, build
from repro_torch.models.attention import attn_dims
from repro_torch.serve import ServeConfig, ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
# every config the port shares with the reference (whisper-medium's,
# xlstm-125m's and hymba-1.5b's models are held against the reference in
# tests/test_torch_encdec.py, test_torch_xlstm.py and test_torch_hybrid.py;
# the port-only nemotron-h-47b against its plain reference in
# tests/test_torch_nemotron_h.py)
NAMES = ("granite-3-8b", "h2o-danube-1.8b", "h2o-danube-3-4b",
         "deepseek-67b", "chameleon-34b", "whisper-medium", "xlstm-125m",
         "hymba-1.5b", "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b")


def masks(t):
    """The all-valid mask and every single dead shard."""
    return [(True,) * t] + [tuple(i != d for i in range(t))
                            for d in range(t)]


def _pair(name, t, r=2, layout="folded"):
    """(reference model, its params re-encoded, port model, port params)
    of ``name`` at smoke size, coded at (t, r)."""
    jmodel = jbuild(jsmoke(jget_arch(name)),
                    JCtx(tp=t, mode="coded", code_r=r, code_layout=layout))
    jparams = jmodel.encode_offline(jmodel.init(jax.random.PRNGKey(0)))
    model = build(smoke_config(get_arch(name)),
                  TPCtx(tp=t, mode="coded", code_r=r, code_layout=layout))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.ctx,
                             device="cpu")
    return jmodel, jparams, model, params


@pytest.mark.parametrize("name", NAMES)
def test_config_copy_matches_reference(name):
    """Every field of each config shared with the reference equals the
    reference's, and so do the derived head width and ``sub_quadratic``;
    the port registers these and its declared port-only names."""
    cfg, jcfg = get_arch(name), jget_arch(name)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.hd == jcfg.hd and cfg.sub_quadratic == jcfg.sub_quadratic
    assert smoke_config(cfg) == smoke_config(cfg)
    assert set(all_archs()) == set(NAMES) | PORT_ONLY
    assert set(NAMES) == set(jbase.all_archs())


def test_attn_dims_follow_the_reference():
    """Padded head counts and GQA groups as the reference computes them,
    for every TP degree up to 16: granite regroups at T = 3 (33 query
    heads over 11 KV heads) and T = 5 (35 over 35), keeps groups of 4 at
    T = 6 and 12 (36 over 9)."""
    for name in NAMES:
        for t in range(1, 17):
            assert attn_dims(get_arch(name), t) == \
                jattn_dims(jget_arch(name), t), (name, t)
    g = get_arch("granite-3-8b")
    assert attn_dims(g, 3) == (33, 11, 3) and attn_dims(g, 5) == (35, 35, 1)
    assert attn_dims(g, 6) == attn_dims(g, 12) == (36, 9, 4)


def test_init_refuses_other_families():
    """Dense bodies, the MoE, the hybrid and xLSTM only: the port refuses
    a family it builds no decoder for (an audio config without an
    encoder, an SSM that is not xLSTM)."""
    base = get_arch("granite-3-8b")
    for kw in ({"family": "audio"}, {"family": "ssm", "ssm_kind": "mamba"}):
        cfg = smoke_config(dataclasses.replace(base, **kw))
        with pytest.raises(NotImplementedError, match="not ported"):
            build(cfg, TPCtx()).init(0, device="cpu")


@pytest.fixture(scope="module")
def fwd_pairs():
    return {name: _pair(name, 4)
            for name in ("granite-3-8b", "h2o-danube-1.8b", "chameleon-34b")}


@pytest.mark.parametrize("dead", [None, 2], ids=["all-valid", "shard2-dead"])
@pytest.mark.parametrize("name", ["granite-3-8b", "h2o-danube-1.8b",
                                  "chameleon-34b"])
def test_forward_matches_reference(fwd_pairs, name, dead):
    """Model.forward: teacher-forced logits [B, S, vocab] within 1e-4 of
    the reference's forward, fault-free and with a shard erased (S = 70
    crosses h2o's 64-token smoke window; several q and KV chunks)."""
    jmodel, jparams, model, params = fwd_pairs[name]
    toks = np.random.default_rng(3).integers(0, model.cfg.vocab, (2, 70))
    valid = np.array([i != dead for i in range(4)])
    want = np.asarray(jmodel.forward(jparams, {"tokens": jnp.asarray(toks)},
                                     jnp.asarray(valid), q_chunk=32,
                                     kv_chunk=16))
    got = model.forward(params, {"tokens": toks}, valid, q_chunk=32,
                        kv_chunk=16)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.fixture(scope="module", params=[3, 12], ids=["T3", "T12"])
def padded(request):
    return request.param, _pair("granite-3-8b", request.param)


def test_padded_heads_are_zero_weight(padded):
    """The padded query heads' wq columns and wo rows, and the padded KV
    heads' wk/wv columns, are zero in the port's params."""
    t, (_, _, model, params) = padded
    cfg = model.cfg
    hq, hkv, _ = attn_dims(cfg, t)
    a = params["layers"]["attn"]
    assert hq > cfg.n_heads
    assert not a["wq"]["w"][..., cfg.n_heads * cfg.hd:hq * cfg.hd].any()
    assert not a["wo"]["w"][..., cfg.n_heads * cfg.hd:hq * cfg.hd, :].any()
    if hkv > cfg.n_kv_heads:
        for nm in ("wk", "wv"):
            assert not a[nm]["w"][..., cfg.n_kv_heads * cfg.hd:
                                  hkv * cfg.hd].any()


def test_padded_logits_under_every_mask(padded):
    """Prefill and decode logits within 1e-4 of the reference's under the
    all-valid mask and every single dead shard."""
    t, (jmodel, jparams, model, params) = padded
    rng = np.random.default_rng(0)
    toks = rng.integers(0, model.cfg.vocab, (2, 6)).astype(np.int32)
    nxt = rng.integers(0, model.cfg.vocab, (2, 1)).astype(np.int32)
    jdecode = jax.jit(jmodel.decode)     # the mask is traced: one compile
    for mask in masks(t):
        v = np.array(mask)
        jst = jmodel.init_decode(jparams, {"tokens": toks}, 2, 16,
                                 jnp.float32, per_row=True)
        jl, jst = jdecode(jparams, jst, jnp.asarray(toks), jnp.asarray(v))
        jl2, _ = jdecode(jparams, jst, jnp.asarray(nxt), jnp.asarray(v))
        st = model.init_decode(params, {"tokens": toks}, 2, 16,
                               torch.float32)
        tl, st = model.decode(params, st, torch.as_tensor(toks), v)
        tl2, _ = model.decode(params, st, torch.as_tensor(nxt), v)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"T={t} mask {mask} prefill")
        np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL,
                                   err_msg=f"T={t} mask {mask} decode")


@pytest.mark.parametrize("use_fused", [True, False],
                         ids=["fused", "reference"])
def test_padded_stream_with_erasure_matches_reference(padded, use_fused):
    """An 8-token greedy stream with shard 1 erased at step 3: identical to
    the reference engine's (which re-encodes its params), on the fused
    round (the kernels' plain versions here) and on the reference
    variant."""
    t, (jmodel, jparams, model, params) = padded
    batch = {"tokens": np.random.default_rng(1).integers(
        0, model.cfg.vocab, (2, 8)).astype(np.int32)}
    want = JEngine(jmodel, jparams, JServeConfig(
        max_len=24, batch=2, cache_dtype=jnp.float32)).generate(
        batch, 8, fail_at={3: 1})
    eng = ServingEngine(model, params, ServeConfig(max_len=24, batch=2),
                        use_fused=use_fused)
    np.testing.assert_array_equal(eng.generate(batch, 8, fail_at={3: 1}),
                                  want)
    assert eng.metrics["erasures_recovered"] == 1


def test_port_init_parity_recovers_padded_heads(padded):
    """The port's own init encodes the parity after zeroing the padded
    heads: a dead shard is recovered (decode logits within 1e-4 of the
    fault-free ones) with the parity ``init`` returns, no re-encode."""
    t, (_, _, model, _) = padded
    params = model.init(0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, model.cfg.vocab, (2, 5)))
    clean, _ = model.decode(params, model.init_decode(params, {}, 2, 8), toks,
                            np.ones(t, bool))
    for mask in masks(t)[1:]:
        got, _ = model.decode(params, model.init_decode(params, {}, 2, 8), toks,
                              np.array(mask))
        np.testing.assert_allclose(got.numpy(), clean.numpy(), **TOL,
                                   err_msg=f"T={t} mask {mask}")


@pytest.mark.parametrize("use_fused", [True, False],
                         ids=["fused", "reference"])
def test_swa_stream_crossing_the_window_matches_reference(use_fused):
    """h2o-danube-1.8b (smoke: window 64) with a 60-token prompt and 8 new
    tokens, so decode crosses the window and the ring cache wraps: tokens
    identical to the reference engine's, with shard 2 erased at step 5."""
    jmodel, jparams, model, params = _pair("h2o-danube-1.8b", 4)
    assert model.cfg.window == 64 and model.cfg.attn_kind == "swa"
    batch = {"tokens": np.random.default_rng(4).integers(
        0, model.cfg.vocab, (2, 60)).astype(np.int32)}
    scfg = dict(max_len=76, batch=2)
    want = JEngine(jmodel, jparams, JServeConfig(
        **scfg, cache_dtype=jnp.float32)).generate(batch, 8,
                                                   fail_at={5: 2})
    eng = ServingEngine(model, params, ServeConfig(**scfg),
                        use_fused=use_fused)
    got = eng.generate(batch, 8, fail_at={5: 2})
    np.testing.assert_array_equal(got, want)
    assert model.init_decode(params, batch, 2, 76)["kv"]["k"].shape[2] == 64


@pytest.mark.parametrize("t", [3, 12])
def test_reference_init_parity_is_stale_under_padded_heads(t):
    """The reference caveat the port does not copy (ROADMAP, Queue C):
    the reference's ``init`` encodes the parity before zeroing the padded
    heads, so with its own parity a dead shard is not recovered (logits
    off by more than 1 at smoke size), while after ``encode_offline`` it
    is (within 1e-4)."""
    jmodel = jbuild(jsmoke(jget_arch("granite-3-8b")),
                    JCtx(tp=t, mode="coded", code_r=2))
    raw = jmodel.init(jax.random.PRNGKey(0))
    toks = jnp.asarray(np.random.default_rng(5).integers(0, 512, (2, 5)))
    jdecode = jax.jit(jmodel.decode)

    def logits(params, valid):
        st = jmodel.init_decode(params, {"tokens": toks}, 2, 8, jnp.float32,
                                per_row=True)
        return np.asarray(jdecode(params, st, toks, jnp.asarray(valid))[0])

    dead = np.array([i != 1 for i in range(t)])
    full = np.ones(t, bool)
    gap = np.abs(logits(raw, dead) - logits(raw, full)).max()
    enc = jmodel.encode_offline(raw)
    fixed = np.abs(logits(enc, dead) - logits(enc, full)).max()
    assert gap > 1.0 and fixed <= 1e-4, (gap, fixed)
