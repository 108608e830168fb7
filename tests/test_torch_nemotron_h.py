"""The port's layer-pattern stack (nemotron-h-47b: Mamba-2, attention and
MLP layers in a published pattern) against its plain reference.

The JAX package has no such architecture, so the port is held to
``bench/reference/nemotron_h.py`` (plain torch, float32, the Mamba-2
recurrence one position at a time) on seeded random weights, at a small
size: d 128, Mamba-2 8 heads of 16, state 16, 2 groups, chunks of 16, the
pattern "M-M*-M" (3 Mamba-2, 2 MLP, 1 attention layer). Covered: the
registration and its pattern cut; the chunked SSD against the sequential
recurrence from a non-zero state; ``forward``; a prefill, then decoding
through the slot state, for prompts that end inside a chunk, on its edge
and past two chunks, the logits at every position against the
reference's full forward; the serving path's slots (a re-admitted slot
carries nothing over; the fused round equals the reference round); one
dead shard under T = 4, r = 2 folded; the scheduler's chunk counter.

Tolerances. Logits are compared within 1e-4 (absolute and relative;
logits up to ~5): the chunked SSD and the coded GEMMs sum in other orders
than the reference's sequential recurrence and plain products, which
moves float32 results by a few 1e-7 relative a layer. The SSD alone is
held to the recurrence within 1e-5 (outputs and states up to ~10).
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import PORT_ONLY, all_archs, get_arch, smoke_config
from repro_torch.models import TPCtx, build, mamba2
from repro_torch.runtime import ContinuousBatchingScheduler, RuntimeConfig
from repro_torch.runtime.executor import SlotPoolExecutor, read_slot
from repro_torch.runtime.scheduler import MAMBA2_CHUNKS
from repro_torch.serve import ModelStepper

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
SSD_TOL = dict(rtol=1e-5, atol=1e-5)
T, R = 4, 2
NAME = "nemotron-h-47b"
PATTERN = "M-M*-M"


def _reference():
    path = ROOT / "bench" / "reference" / "nemotron_h.py"
    spec = importlib.util.spec_from_file_location("nemotron_h_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(**over):
    over = {"pattern": PATTERN, "n_layers": len(PATTERN), **over}
    return dataclasses.replace(smoke_config(get_arch(NAME)), **over)


def ref_cfg(cfg) -> dict:
    """The configuration file's keys of ``cfg``, as the reference reads
    them."""
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
            "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab,
            "num_hidden_layers": cfg.n_layers,
            "hybrid_override_pattern": cfg.pattern,
            "mamba_num_heads": cfg.mamba_heads,
            "mamba_head_dim": cfg.mamba_head_dim,
            "n_groups": cfg.mamba_groups, "ssm_state_size": cfg.ssm_state,
            "conv_kernel": cfg.conv_kernel, "rms_norm_eps": cfg.norm_eps}


def _model(mode="coded", seed=0, **over):
    cfg = small(**over)
    ctx = TPCtx(tp=T, mode=mode, code_r=R) if mode == "coded" else TPCtx()
    model = build(cfg, ctx)
    return model, model.init(seed, device="cpu")


def _tokens(cfg, n, seed=3):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, n))


def _want(model, raw, toks):
    return REF.forward(ref_cfg(model.cfg), raw, toks)


def _valid(dead=None):
    v = torch.ones(T, dtype=torch.bool)
    if dead is not None:
        v[dead] = False
    return v


# ---------------------------------------------------------- registration ----

def test_registration_and_the_pattern_cut():
    """Published sizes and the full 98-layer pattern (45 Mamba-2, 48 MLP,
    5 attention); ``n_layers`` takes the pattern's first characters, as
    the benchmark's 19-layer cut does; the port's only name beyond the
    reference's ten is the declared port-only one."""
    cfg = get_arch(NAME)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
            cfg.vocab) == (8192, 64, 8, 128, 30720, 131072)
    assert (cfg.mamba_heads, cfg.mamba_head_dim, cfg.mamba_groups,
            cfg.ssm_state, cfg.mamba_chunk, cfg.conv_kernel) == \
        (256, 64, 8, 256, 128, 4)
    assert (cfg.mamba_inner, cfg.mamba_conv_dim) == (16384, 20480)
    assert len(cfg.layer_kinds) == 98 and cfg.act == "relu2" \
        and not cfg.rope
    assert [cfg.layer_kinds.count(k) for k in "M-*"] == [45, 48, 5]
    cut = dataclasses.replace(cfg, n_layers=19)
    assert cut.layer_kinds == "M-M-M-M-M-M-M-M-M*-"
    assert [cut.layer_kinds.count(k) for k in "M-*"] == [9, 9, 1]
    assert 46e9 < cfg.param_count < 48e9
    assert NAME in all_archs() and PORT_ONLY == {NAME}
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, n_layers=99).layer_kinds


def test_params_and_state_are_grouped_by_kind():
    """Every leaf stacked [L_kind, ...]; the state's slots on axis 1: KV
    for the attention layers only, beside the Mamba-2 conv window and
    SSM state (float32)."""
    model, params = _model()
    cfg = model.cfg
    lay = params["layers"]
    assert set(lay) == {"mamba2", "attn", "mlp"}
    assert lay["mamba2"]["mixer"]["in_proj"]["w"].shape == \
        (3, cfg.d_model, T * T * -(-(2 * cfg.mamba_inner + 4 * 16 + 8)
                                   // (T * T)))
    assert lay["mamba2"]["mixer"]["conv_w"].shape == (3, 4, 192)
    assert lay["mamba2"]["ln"]["g"].shape == (3, cfg.d_model)
    assert lay["attn"]["mixer"]["wq"]["w"].shape[0] == 1
    assert "w3" not in lay["mlp"]["mixer"]
    st = model.empty_decode(5, 40, device="cpu")
    assert set(st) == {"kv", "mamba2"}
    assert st["kv"]["k"].shape[:2] == (1, 5)
    assert st["mamba2"]["conv"].shape == (3, 5, 3, 192)
    assert st["mamba2"]["ssm"].shape == (3, 5, 8, 16, 16)
    assert st["mamba2"]["ssm"].dtype == torch.float32
    no_attn = build(small(pattern="M-", n_layers=2), TPCtx())
    assert set(no_attn.empty_decode(2, 8, device="cpu")) == {"mamba2"}


# ------------------------------------------------------------------ SSD ----

def _sequential(x, dt, a, bm, cm, h0):
    """h <- exp(dt·A)·h + dt·x ⊗ B[g]; y = h·C[g], one position at a time."""
    b, s, nh, p = x.shape
    r = nh // bm.shape[-2]
    bh, ch = (t.repeat_interleave(r, dim=2) for t in (bm, cm))
    h, ys = h0.clone(), []
    for t in range(s):
        h = torch.exp(dt[:, t] * a)[..., None, None] * h \
            + (dt[:, t, :, None] * x[:, t])[..., None] * bh[:, t, :, None, :]
        ys.append((h * ch[:, t, :, None, :]).sum(-1))
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("s,chunk", [(5, 16), (16, 16), (37, 16),
                                     (48, 8), (1, 4)])
def test_chunked_ssd_matches_the_recurrence_from_a_nonzero_state(s, chunk):
    gen = torch.Generator().manual_seed(s * 100 + chunk)
    b, nh, p, g, n = 2, 8, 4, 2, 6

    def rnd(*shape):
        return torch.randn(shape, generator=gen)

    x, bm, cm = rnd(b, s, nh, p), rnd(b, s, g, n), rnd(b, s, g, n)
    dt = torch.nn.functional.softplus(rnd(b, s, nh))
    a = -torch.rand(nh, generator=gen) * 4 - 0.1
    h0 = rnd(b, nh, p, n)
    y, h = mamba2.ssd(x, dt, a, bm, cm, chunk, h0)
    want_y, want_h = _sequential(x, dt, a, bm, cm, h0)
    torch.testing.assert_close(y, want_y, **SSD_TOL)
    torch.testing.assert_close(h, want_h, **SSD_TOL)
    y0, _ = mamba2.ssd(x, dt, a, bm, cm, chunk)
    torch.testing.assert_close(
        y0, _sequential(x, dt, a, bm, cm, torch.zeros_like(h0))[0],
        **SSD_TOL)


# -------------------------------------------------------------- forward ----

@pytest.mark.parametrize("mode", ["plain", "coded"])
def test_forward_matches_reference(mode):
    """Teacher-forced logits over 37 tokens (two chunks and a part)."""
    model, raw = _model(mode)
    params = model.encode_offline(raw)
    toks = _tokens(model.cfg, 37)
    valid = _valid() if mode == "coded" else None
    with torch.no_grad():
        got = model.forward(params, {"tokens": toks[None]}, valid)[0]
    want = _want(model, raw, toks)
    assert got.shape == want.shape == (37, model.cfg.vocab)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("prompt", [21, 32, 40],
                         ids=["inside-a-chunk", "on-the-edge",
                              "past-two-chunks"])
def test_prefill_then_decode_matches_reference(prompt):
    """A prefill into a fresh state (the SSD from zero, its final state
    and conv window written into the state), then 9 tokens decoded one at
    a time through that state: the logits at every prompt position and
    at every decoded one equal the reference's full forward."""
    model, raw = _model()
    params = model.encode_offline(raw)
    toks = _tokens(model.cfg, prompt + 9, seed=prompt)
    valid = _valid()
    with torch.no_grad():
        state = model.init_decode(params, {}, 1, 64)
        logits, state = model.decode(params, state, toks[None, :prompt],
                                     valid)
        outs = [logits[0]]
        for t in range(prompt, prompt + 9):
            logits, state = model.decode(params, state, toks[None, t:t + 1],
                                         valid)
            outs.append(logits[0])
    got = torch.cat(outs)
    torch.testing.assert_close(got, _want(model, raw, toks), **TOL)
    assert int(state["kv"]["len"][0, 0]) == prompt + 9


@pytest.mark.parametrize("dead", [0, 1, 2, 3])
def test_one_dead_shard_matches_reference(dead):
    """T = 4, r = 2 folded with one shard lost (the whole budget the
    serving path takes through the fused kernels): the forward and a
    prefill-then-decode stream equal the reference's fault-free logits."""
    model, raw = _model()
    params = model.encode_offline(raw)
    toks = _tokens(model.cfg, 30, seed=dead)
    valid = _valid(dead)
    want = _want(model, raw, toks)
    with torch.no_grad():
        got = model.forward(params, {"tokens": toks[None]}, valid)[0]
        state = model.init_decode(params, {}, 1, 64)
        logits, state = model.decode(params, state, toks[None, :24], valid)
        outs = [logits[0]]
        for t in range(24, 30):
            logits, state = model.decode(params, state, toks[None, t:t + 1],
                                         valid)
            outs.append(logits[0])
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(torch.cat(outs), want, **TOL)


# ------------------------------------------------------------- serving ----

def _greedy_reference(model, raw, prompt, n):
    """n greedy tokens after ``prompt``, each from the reference's full
    forward over what came before."""
    seq = list(prompt)
    for _ in range(n):
        logits = REF.forward(ref_cfg(model.cfg), raw, torch.as_tensor(seq))
        seq.append(int(torch.argmax(logits[-1])))
    return seq[len(prompt):]


@pytest.mark.parametrize("fused", [False, True],
                         ids=["reference-round", "fused-round"])
def test_readmitted_slot_carries_no_state(fused):
    """Two slots. Slot 0 serves request A for 6 rounds, is evicted and
    takes request B while slot 1 serves C throughout: B's and C's tokens
    are the reference's greedy tokens, so nothing of A's KV, conv window
    or SSM state carried over into B's row, nor across rows; B's row right
    after its admission is, leaf for leaf, a fresh prefill's (A's state
    fades within a few tokens of B's, so the tokens alone would miss a
    prefill that starts from it). The fused round (the kernels' plain
    versions on the CPU) gives the same tokens."""
    model, raw = _model()
    stepper = ModelStepper(model, raw, max_len=64)
    pool = SlotPoolExecutor(stepper, 2, overlap=False, use_fused=fused,
                            use_graphs=False)
    valid = np.ones(T, bool)
    rng = np.random.default_rng(11)
    a, b, c = (rng.integers(0, model.cfg.vocab, n) for n in (19, 23, 33))
    got = {"c": [pool.admit(1, c, valid, tag="c")]}
    pool.admit(0, a, valid, tag="a")
    for _ in range(6):
        for slot, tag, tok in pool.step_round(valid):
            got.setdefault(tag, []).append(tok)
    pool.evict(0)
    got["b"] = [pool.admit(0, b, valid, tag="b")]
    _, fresh = stepper.prefill({"tokens": b[None]}, valid)
    row = read_slot(pool.state, 0)
    for name in ("conv", "ssm"):
        assert torch.equal(row["mamba2"][name], fresh["mamba2"][name])
    for name in ("k", "v", "pos", "len"):
        assert torch.equal(row["kv"][name], fresh["kv"][name])
    for _ in range(5):
        for slot, tag, tok in pool.step_round(valid):
            got[tag].append(tok)
    assert got["b"] == _greedy_reference(model, raw, b, 6)
    assert got["c"] == _greedy_reference(model, raw, c, 12)


def test_scheduler_counts_the_prefill_chunks():
    """``mamba2_prefill_chunks`` counts the SSD chunks every admission's
    prefill takes through the Mamba-2 layers (3 a chunk of 16 here); no
    ``prefill.mamba`` event without a card. A model without Mamba-2 layers
    registers no such counter."""
    model, raw = _model()
    stepper = ModelStepper(model, raw, max_len=64)
    sched = ContinuousBatchingScheduler(stepper, RuntimeConfig(n_slots=2))
    lens = (5, 16, 17, 40)
    rng = np.random.default_rng(2)
    for n in lens:
        sched.submit(rng.integers(0, model.cfg.vocab, n), 3)
    while sched.busy:
        sched.step()
    assert len(sched.completed) == len(lens)
    assert sched.metrics.counters[MAMBA2_CHUNKS] == \
        3 * sum(-(-n // 16) for n in lens)
    assert mamba2.prefill_chunks(model.cfg, 33) == 9
    granite = build(smoke_config(get_arch("granite-3-8b")), TPCtx())
    plain = ContinuousBatchingScheduler(
        ModelStepper(granite, granite.init(0, device="cpu"), max_len=16),
        RuntimeConfig(n_slots=1))
    assert MAMBA2_CHUNKS not in plain.metrics.counters
