"""Training the port's other families against the reference: qwen2-moe-a2.7b
(capacity 1.25, with dropped pairs), hymba-1.5b (the mamba scan under
autograd), xlstm-125m (the chunkwise mLSTM and the sLSTM loop) and
whisper-medium (frames in the batch), at smoke size, coded at T = 4, r = 2
folded.

Params come from the reference's ``encode_offline(init(...))`` through
``params_from_jax``; token batches from the port's data stream (equal to
the reference's to the bit), whisper's frames from a numpy seed. Held
against the JAX package: the loss (1e-5) and every gradient leaf (1e-4)
of ``jax.value_and_grad`` over ``make_loss_fn``, fault-free and with
shard 2 dead, and three train steps' losses and params (1e-4). Also: the
MoE drops pairs at capacity 1.25 and still matches, ``aux_loss_weight``
adds nothing (as in the reference), the decoder families train through
the ``Trainer`` (the loss falls, a resume continues the losses), and the
mamba scan differentiates while serving still writes the state in place.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
from repro.models import TPCtx as JCtx, build as jbuild
from repro.models import common as jcommon
from repro.optim import adamw as jadamw
from repro.train import train_step as jtrain
from repro_torch.configs import get_arch, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.data import pipeline as tdata
from repro_torch.models import TPCtx, build, ffn, mamba
from repro_torch.optim import adamw as tadamw
from repro_torch.train import (Trainer, TrainerConfig, TrainConfig,
                               make_grad_fn, make_train_step)
from repro_torch.train.train_step import make_loss_fn
from repro_torch.tree import named_leaves

T, R = 4, 2
FAMILIES = ["qwen2-moe-a2.7b", "hymba-1.5b", "xlstm-125m", "whisper-medium"]
ALL = np.ones(T, bool)
DEAD2 = np.arange(T) != 2
# eps 1e-6 (both packages): Adam's step on an element is g / (|g| + eps),
# whose slope in g is up to 1 / eps. With the default 1e-8, an element whose
# gradient cancels to ~1e-8 (as one of qwen2-moe's embed elements does at
# step 3) turns the packages' 3e-8 float difference in it into a 1.7e-4
# param difference; at 1e-6 that difference stays below ~3e-5
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10, eps=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
CHUNK_TOL = dict(rtol=2e-4, atol=2e-4)    # as tests/test_torch_xlstm.py's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's smoke-size ops: the suite runs
    in several worker processes at once, and their thread pools would
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jnamed(tree) -> dict:
    """{name: numpy array} of a reference tree, named as the port names
    its leaves."""
    paths, _ = jax.tree_util.tree_flatten_with_path(tree)

    def name(p):
        return "/".join(f"#{k.idx}" if isinstance(k, jax.tree_util.SequenceKey)
                        else str(k.key) for k in p)
    return {name(p): np.asarray(x) for p, x in paths}


def _named_np(tree) -> dict:
    return {n: x.detach().numpy() for n, x in named_leaves(tree)
            if x is not None}


@functools.lru_cache(maxsize=None)
def _pair(name: str):
    """(reference model, its params as numpy, port model) of ``name`` at
    smoke size, coded, MoE capacity 1.25 (both packages' default)."""
    jmodel = jbuild(jsmoke(jget_arch(name)),
                    JCtx(tp=T, mode="coded", code_r=R, moe_capacity=1.25))
    jparams = jax.tree.map(np.asarray, jax.jit(
        lambda k: jmodel.encode_offline(jmodel.init(k)))(
            jax.random.PRNGKey(0)))
    model = build(smoke_config(get_arch(name)),
                  TPCtx(tp=T, mode="coded", code_r=R, moe_capacity=1.25))
    return jmodel, jparams, model


def _batch(cfg, step: int = 0, b: int = 4, s: int = 16) -> dict:
    """Step ``step`` of the port's token stream; whisper adds float32 numpy
    frames drawn from the step's seed."""
    dcfg = tdata.DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b,
                            seed=7)
    out = {"tokens": tdata._synthetic_batch(dcfg, step)}
    if cfg.is_encdec:
        out["frames"] = np.random.default_rng(100 + step).normal(
            size=(b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _jitted(name: str):
    """The reference's value_and_grad, jitted once with the mask a traced
    input (one compile serves every mask), and its AdamW update. Its train
    step with one microbatch is these two in a row
    (``repro.train.train_step.make_train_step``); running them as two jits
    spares a third compile of the model."""
    jmodel, _, _ = _pair(name)
    loss_fn = jtrain.make_loss_fn(jmodel, jtrain.TrainConfig(remat="none"))
    vg = jax.jit(jax.value_and_grad(loss_fn))
    update = jax.jit(functools.partial(jadamw.apply_updates,
                                       jadamw.AdamWConfig(**OPT)))
    return vg, update


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference_grad(name: str, dead: bool):
    jmodel, jparams, _ = _pair(name)
    vg, _ = _jitted(name)
    v = jnp.asarray(DEAD2 if dead else ALL)
    loss, grads = vg(jax.tree.map(jnp.asarray, jparams),
                     _jbatch(_batch(jmodel.cfg)), v)
    return float(loss), _jnamed(grads)


@functools.lru_cache(maxsize=None)
def _reference_steps(name: str):
    jmodel, jparams, _ = _pair(name)
    vg, update = _jitted(name)
    jp = jax.tree.map(jnp.asarray, jparams)
    state, losses = jadamw.init_state(jp), []
    for i in range(3):
        loss, grads = vg(jp, _jbatch(_batch(jmodel.cfg, step=i)),
                         jnp.asarray(ALL))
        jp, state, _ = update(jp, grads, state)
        losses.append(float(loss))
    return losses, _jnamed(jp)


def _port_params(name: str):
    _, jparams, model = _pair(name)
    return model, params_from_jax(jparams, model.ctx, device="cpu")


def _check_grads(got: dict, want: dict, dead: bool, name: str):
    for leaf, w in want.items():
        if leaf not in got:        # the loss never read it: zeros
            assert leaf.endswith("/cdc") and not dead, leaf
            np.testing.assert_array_equal(w, 0.0, err_msg=leaf)
            continue
        np.testing.assert_allclose(got[leaf], w, **GRAD_TOL,
                                   err_msg=f"{name} {leaf}")


# ------------------------------------------------------ loss and grads ----

@pytest.mark.parametrize("dead", [False, True], ids=["fault-free", "dead2"])
@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_gradients_match_the_reference(name, dead):
    """The loss within 1e-5 and every gradient leaf within 1e-4 of
    jax.value_and_grad's (the port under remat "full", its default; the
    reference's numbers do not depend on remat). With shard 2 dead the
    parity leaves carry real gradients."""
    model, params = _port_params(name)
    valid = DEAD2 if dead else ALL
    jloss, jg = _reference_grad(name, dead)
    loss, grads = make_grad_fn(model, TrainConfig())(
        params, _batch(model.cfg), valid)
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    got = _named_np(grads)
    _check_grads(got, jg, dead, name)
    if dead:
        assert np.abs(got["lm_head/cdc"]).max() > 0
    assert not any(p.requires_grad for _, p in named_leaves(params))


@pytest.mark.parametrize("name", FAMILIES)
def test_three_train_steps_match_the_reference(name):
    """Three steps of ``make_train_step`` (AdamW with warmup, clipping):
    each loss and every param after the third within 1e-4."""
    model, params = _port_params(name)
    jlosses, jp = _reference_steps(name)
    step = make_train_step(model, tadamw.AdamWConfig(**OPT), TrainConfig())
    state = tadamw.init_state(params)
    for i, want in enumerate(jlosses):
        params, state, m = step(params, state, _batch(model.cfg, step=i),
                                ALL)
        assert float(m["loss"]) == pytest.approx(want, rel=1e-4, abs=1e-4)
    got = _named_np(params)
    for leaf, want in jp.items():
        np.testing.assert_allclose(got[leaf], want, **GRAD_TOL,
                                   err_msg=f"{name} {leaf}")


def test_moe_drops_pairs_at_capacity_and_still_matches(monkeypatch):
    """qwen2-moe at capacity 1.25: the batch routes more pairs to some
    experts than they hold (pairs are dropped), and the loss and gradient
    (the router's through the gate values) still match the reference's."""
    model, params = _port_params("qwen2-moe-a2.7b")
    dropped = []
    route = ffn._route

    def counting(*a):
        out = route(*a)
        dropped.append(int((~out[4]).sum()))
        return out
    monkeypatch.setattr(ffn, "_route", counting)
    loss, grads = make_grad_fn(model, TrainConfig(remat="none"))(
        params, _batch(model.cfg), ALL)
    assert sum(dropped) > 0, dropped
    jloss, jg = _reference_grad("qwen2-moe-a2.7b", False)
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    got = _named_np(grads)
    _check_grads(got, jg, False, "qwen2-moe")
    assert np.abs(got["layers/moe/router/w"]).max() > 0


def test_aux_loss_weight_is_read_and_adds_nothing():
    """``TrainConfig(aux_loss_weight=...)`` exists as the reference's does
    and, as there, adds nothing to the MoE's loss: the port's loss at 0.5
    and at 0 is the same, and the reference's at 0.5 is its loss at the
    default 0.01."""
    jmodel, jparams, model = _pair("qwen2-moe-a2.7b")
    params = params_from_jax(jparams, model.ctx, device="cpu")
    batch = _batch(model.cfg)
    assert TrainConfig().aux_loss_weight == \
        jtrain.TrainConfig().aux_loss_weight == 0.01
    with torch.no_grad():
        got = [float(make_loss_fn(model, TrainConfig(aux_loss_weight=w))(
            params, batch, ALL)) for w in (0.5, 0.0)]
    want = float(jax.jit(jtrain.make_loss_fn(
        jmodel, jtrain.TrainConfig(aux_loss_weight=0.5, remat="none")))(
            jax.tree.map(jnp.asarray, jparams), _jbatch(batch),
            jnp.asarray(ALL)))
    assert want == _reference_grad("qwen2-moe-a2.7b", False)[0]
    assert got[0] == got[1]
    assert got[0] == pytest.approx(want, rel=1e-5)


# ------------------------------------------------------------ the scan ----

def test_mamba_scan_differentiates_and_serving_writes_in_place():
    """hymba's scan under autograd: its outputs and the gradients of the
    decay, drive and readout against jax.vjp of the reference's
    ``chunked_time_scan`` (S = 128, two checkpointed chunks) within 1e-5;
    outside grad mode a step still advances the given state in place."""
    rng = np.random.default_rng(3)
    b, s, di, n = 2, 128, 8, 4
    decay = rng.uniform(0.5, 1.0, (b, s, di, n)).astype(np.float32)
    drive = rng.normal(size=(b, s, di, n)).astype(np.float32)
    c = rng.normal(size=(b, s, n)).astype(np.float32)
    dy = rng.normal(size=(b, s, di)).astype(np.float32)

    def jscan(decay, drive, c):
        def step(h, inp):
            a, u, ct = inp
            h = a * h + u
            return h, jnp.einsum("bdn,bn->bd", h, ct)
        xs = (jnp.moveaxis(decay, 1, 0), jnp.moveaxis(drive, 1, 0),
              jnp.moveaxis(c, 1, 0))
        _, ys = jcommon.chunked_time_scan(step, jnp.zeros((b, di, n)), xs)
        return jnp.moveaxis(ys, 0, 1)
    jy, vjp = jax.vjp(jax.jit(jscan), decay, drive, c)
    jgrads = vjp(jnp.asarray(dy))

    ins = [torch.tensor(a, requires_grad=True) for a in (decay, drive, c)]
    h = torch.zeros((b, di, n))
    y = mamba._scan(*ins, h)
    y.backward(torch.as_tensor(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    for t, want in zip(ins, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        state = torch.zeros((b, di, n))
        ptr = state.data_ptr()
        one = [torch.as_tensor(a[:, :1]) for a in (decay, drive, c)]
        mamba._scan(*one, state)
    assert state.data_ptr() == ptr
    np.testing.assert_array_equal(state.numpy(), drive[:, 0])


@pytest.mark.parametrize("f_scale", [0.02, 1.0])
def test_mlstm_chunk_gradient_is_finite_where_the_reference_overflows(
        f_scale):
    """The chunkwise mLSTM's gradient over one 128-step chunk. With small
    forget-gate logs (f_scale 0.02) both packages' gradients are finite
    and agree within 2e-4 (the chunkwise form's tolerance in
    tests/test_torch_xlstm.py: sums of 128 products reassociated). With
    log-sigmoid(N(0, 1)) forget gates (f_scale 1, as at full width) the
    gate sums reach ~90 and the reference's
    exp(g_tau - M_t) above the diagonal overflows to inf, so its gradient
    is NaN (``repro/models/xlstm.py``'s chunk_step); the port masks the
    exponent first and its gradient stays finite, with the same h."""
    from repro.models import xlstm as jxlstm
    from repro_torch.models import xlstm
    rng = np.random.default_rng(4)
    b, s, nh, dh = 2, 128, 2, 8
    q, k, v = (rng.normal(size=(b, s, nh, dh)).astype(np.float32)
               for _ in range(3))
    i_raw = rng.normal(size=(b, s, nh)).astype(np.float32)
    f_log = (f_scale * np.log(1 / (1 + np.exp(-rng.normal(
        size=(b, s, nh)))))).astype(np.float32)
    state = (np.zeros((b, nh, dh, dh), np.float32),
             np.zeros((b, nh, dh), np.float32),
             np.full((b, nh), -1e30, np.float32))
    dh_out = rng.normal(size=(b, s, nh, dh)).astype(np.float32)

    def jloss(*a):
        h, _ = jxlstm._mlstm_chunkwise(*a, *state)
        return jnp.sum(h * dh_out), h
    (_, jh), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
            q, k, v, i_raw, f_log)
    ins = [torch.tensor(a, requires_grad=True)
           for a in (q, k, v, i_raw, f_log)]
    h, _ = xlstm._mlstm_chunkwise(*ins, *map(torch.as_tensor, state))
    (h * torch.as_tensor(dh_out)).sum().backward()
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh),
                               **CHUNK_TOL)
    assert all(torch.isfinite(t.grad).all() for t in ins)
    if f_scale < 1:
        for t, want in zip(ins, jg):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                       **CHUNK_TOL)
    else:
        assert not all(np.isfinite(np.asarray(g)).all() for g in jg)


# ------------------------------------------------------------ trainer ----

def _trainer(name: str, ckpt_dir: str, steps: int, ckpt_every: int):
    cfg = smoke_config(get_arch(name))
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R,
                             moe_capacity=1.25))
    return Trainer(
        model, TrainerConfig(steps=steps, ckpt_dir=ckpt_dir,
                             ckpt_every=ckpt_every, log_every=1,
                             device="cpu"),
        tadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=40,
                           schedule="constant", weight_decay=0.0),
        TrainConfig(remat="none"),
        tdata.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4))


@pytest.mark.parametrize("name", FAMILIES[:3])
def test_decoder_families_train_and_resume_through_the_trainer(name,
                                                               tmp_path):
    """The Trainer (smoke, coded): over 8 steps the loss falls; a second
    trainer resumed from the step-4 checkpoint gives steps 5-8's losses
    within 1e-5 (whisper has no token-only stream to train on, as in the
    reference)."""
    full = _trainer(name, str(tmp_path / "a"), 8, 4).run(resume=False)
    losses = [l for _, l in full["losses"]]
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses
    (tmp_path / "b").mkdir()
    (tmp_path / "a" / "step_00000004").rename(
        tmp_path / "b" / "step_00000004")
    resumed = _trainer(name, str(tmp_path / "b"), 8, 100).run(resume=True)
    assert [s for s, _ in resumed["losses"]] == [5, 6, 7, 8]
    for (s, l), (s0, l0) in zip(resumed["losses"], full["losses"][4:]):
        assert s == s0 and l == pytest.approx(l0, rel=1e-5)
