"""The port's training path against the reference: the data stream, AdamW,
the loss, the train step (every remat policy, microbatches, a dead
shard), the RMSNorm gradient, checkpoints across the two packages, the
trainer with resume, and the SIGTERM path.

Inputs come from numpy seeds; params come from the reference's
``encode_offline(init(...))`` through ``params_from_jax``, so both sides
hold the same weights. On the CPU the port's norms run their plain
versions inside the same autograd Function that runs kernel 6 and its
backward kernel on the card (``kernels.rmsnorm.RMSNormGrad``).
"""
import functools
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
from repro.data import pipeline as jdata
from repro.models import TPCtx as JCtx, build as jbuild
from repro.models import common as jcommon
from repro.optim import adamw as jadamw
from repro.train import train_step as jtrain
from repro_torch import ckpt as tckpt
from repro_torch.configs import get_arch, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.data import pipeline as tdata
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref as kref
from repro_torch.kernels import rmsnorm as krmsnorm
from repro_torch.launch import train as tlaunch
from repro_torch.models import TPCtx, build
from repro_torch.models.common import encode_tree
from repro_torch.optim import adamw as tadamw
from repro_torch.train import (Trainer, TrainerConfig, TrainConfig,
                               make_grad_fn, make_train_step)
from repro_torch.train import train_step as ttrain
from repro_torch.tree import named_leaves

T, R = 4, 2
DEAD2 = np.arange(T) != 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's smoke-size ops: the suite runs
    in several worker processes at once, and their thread pools would
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _named_np(tree) -> dict:
    """{name: numpy array} of a port tree (None leaves left out)."""
    return {n: x.detach().numpy() for n, x in named_leaves(tree)
            if x is not None}


def _jnamed(tree) -> dict:
    """{name: numpy array} of a reference tree, named as the checkpoint
    names its leaves."""
    paths, _ = jax.tree_util.tree_flatten_with_path(tree)

    def name(p):
        return "/".join(f"#{k.idx}" if isinstance(k, jax.tree_util.SequenceKey)
                        else str(k.key) for k in p)
    return {name(p): np.asarray(x) for p, x in paths}


# ------------------------------------------------------------------ data ----

@pytest.mark.parametrize("seed,step,host", [(1234, 0, 0), (1234, 7, 0),
                                            (5, 3, 1), (99, 1000, 3)])
def test_synthetic_batches_equal_the_reference_to_the_bit(seed, step, host):
    kw = dict(vocab=50304, seq_len=33, global_batch=8, seed=seed,
              host_index=host, host_count=4)
    got = tdata._synthetic_batch(tdata.DataConfig(**kw), step)
    want = jdata._synthetic_batch(jdata.DataConfig(**kw), step)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    tstream = tdata.make_stream(tdata.DataConfig(**kw), start_step=step)
    jstream = jdata.make_stream(jdata.DataConfig(**kw), start_step=step)
    for _ in range(3):
        np.testing.assert_array_equal(next(tstream)["tokens"],
                                      next(jstream)["tokens"])


def test_memmap_stream_equals_the_reference(tmp_path):
    tpath, jpath = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    tdata.write_corpus(tpath, vocab=1000, n_tokens=20000, seed=3)
    jdata.write_corpus(jpath, vocab=1000, n_tokens=20000, seed=3)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    kw = dict(vocab=1000, seq_len=64, global_batch=4, kind="memmap",
              path=tpath, seed=11)
    tstream = tdata.make_stream(tdata.DataConfig(**kw), start_step=2)
    jstream = jdata.make_stream(jdata.DataConfig(**kw), start_step=2)
    for _ in range(3):
        np.testing.assert_array_equal(next(tstream)["tokens"],
                                      next(jstream)["tokens"])


# ----------------------------------------------------------------- adamw ----

@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_schedule_matches_the_reference(schedule):
    kw = dict(lr=3e-3, warmup_steps=7, total_steps=50, schedule=schedule)
    tcfg, jcfg = tadamw.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
    for step in range(0, 60):
        got = float(tadamw.lr_at(tcfg, torch.tensor(step, dtype=torch.int32)))
        want = float(jadamw.lr_at(jcfg, jnp.asarray(step, jnp.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def _random_tree(rng):
    return {"a": {"w": rng.normal(size=(6, 5)).astype(np.float32),
                  "g": rng.normal(size=(5,)).astype(np.float32)},
            "blocks": [{"w": rng.normal(size=(3, 4, 2)).astype(np.float32)},
                       {"b": rng.normal(size=(7,)).astype(np.float32)}],
            "unused": {"w": rng.normal(size=(4, 4)).astype(np.float32)}}


def test_apply_updates_matches_the_reference():
    """Three AdamW steps on a random tree with 1-D leaves (no decay), a
    global norm above the clip, and a leaf with no gradient (None in the
    port, zeros in the reference: its moments still decay and its master
    copy still takes weight decay)."""
    rng = np.random.default_rng(0)
    params = _random_tree(rng)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5,
              weight_decay=0.1)
    tcfg, jcfg = tadamw.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
    tp = jax.tree.map(torch.as_tensor, params)
    tstate = tadamw.init_state(tp)
    assert all(m.data_ptr() != p.data_ptr() for m, p in
               zip(jax.tree.leaves(tstate["master"]), jax.tree.leaves(tp)))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jadamw.init_state(jp)
    japply = jax.jit(functools.partial(jadamw.apply_updates, jcfg))
    for _ in range(3):
        grads = jax.tree.map(
            lambda p: (10 * rng.normal(size=p.shape)).astype(np.float32),
            params)
        grads["unused"]["w"] = np.zeros((4, 4), np.float32)
        tg = jax.tree.map(torch.as_tensor, grads)
        tg["unused"]["w"] = None
        tp, tstate, tm = tadamw.apply_updates(tcfg, tp, tg, tstate)
        jp, jstate, jm = japply(jp, jax.tree.map(jnp.asarray, grads),
                                jstate)
        assert float(jm["grad_norm"]) > kw["grad_clip"]
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        for name, want in _jnamed({"p": jp, "s": jstate}).items():
            np.testing.assert_allclose(
                _named_np({"p": tp, "s": tstate})[name], want, rtol=1e-6,
                atol=1e-6, err_msg=name)


def test_lm_loss_matches_the_reference():
    rng = np.random.default_rng(1)
    logits = (3 * rng.normal(size=(3, 9, 37))).astype(np.float32)
    tokens = rng.integers(0, 37, (3, 9)).astype(np.int32)
    got = float(ttrain.lm_loss(torch.as_tensor(logits),
                               torch.as_tensor(tokens), 37))
    want = float(jax.jit(jtrain.lm_loss, static_argnums=2)(
        jnp.asarray(logits), jnp.asarray(tokens), 37))
    assert got == pytest.approx(want, rel=1e-6)


# --------------------------------------------------------------- rmsnorm ----

@pytest.mark.parametrize("shape,strided", [((5, 64), False),
                                           ((2, 3, 128), False),
                                           ((4, 7, 96), True)])
def test_rmsnorm_gradient_matches_jax_vjp(shape, strided):
    """``ref.rmsnorm_bwd_ref`` and the autograd Function around kernel 6
    (plain versions on the CPU) against jax.vjp of the reference's
    ``common.rmsnorm``; strided rows as the last positions of sequences."""
    rng = np.random.default_rng(2)
    x = (2 * rng.normal(size=shape)).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    if strided:
        x = x[:, -1:]
    dy = rng.normal(size=x.shape).astype(np.float32)
    eps = 1e-5
    @jax.jit
    def jvjp(x, g, dy):
        y, vjp = jax.vjp(lambda x, g: jcommon.rmsnorm({"g": g}, x, eps), x,
                         g)
        return (y,) + vjp(dy)
    y, jdx, jdg = jvjp(jnp.asarray(x), jnp.asarray(g), jnp.asarray(dy))
    xt = torch.as_tensor(np.ascontiguousarray(x))
    dx, dg = kref.rmsnorm_bwd_ref(xt, torch.as_tensor(g),
                                  torch.as_tensor(dy), eps)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dg.numpy(), np.asarray(jdg), rtol=1e-5,
                               atol=1e-5)
    xr = torch.as_tensor(x).requires_grad_(True)
    gr = torch.as_tensor(g).requires_grad_(True)
    out = krmsnorm.rmsnorm(xr, gr, eps=eps)
    assert out.grad_fn is not None and "RMSNormGrad" in out.grad_fn.name()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               rtol=1e-6, atol=1e-6)
    out.backward(torch.as_tensor(dy))
    np.testing.assert_allclose(xr.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gr.grad.numpy(), np.asarray(jdg), rtol=1e-5,
                               atol=1e-5)


def test_rmsnorm_bwd_plan():
    assert krmsnorm.rmsnorm_bwd_plan(4096, 4096) == 4
    assert krmsnorm.rmsnorm_bwd_plan(1024, 1024) == 1
    assert krmsnorm.rmsnorm_bwd_plan(8192, 8192) == 8
    assert krmsnorm.rmsnorm_bwd_plan(12800, 12800) == 0   # beyond registers
    assert krmsnorm.rmsnorm_bwd_plan(4093, 4093) == 0     # ragged rows
    assert krmsnorm.rmsnorm_bwd_plan(4096, 4097) == 0     # ragged stride
    assert krmsnorm.rmsnorm_bwd_plan(4096, 4096, False) == 0


def test_kernels_without_a_backward_refuse_a_requires_grad_input():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        kbuild.refuse_grad("cdc_encode", torch.ones(2), x)
    with torch.no_grad():
        kbuild.refuse_grad("cdc_encode", x)
    kbuild.refuse_grad("cdc_encode", torch.ones(2), None)


# ------------------------------------------------------------ train step ----

@functools.lru_cache(maxsize=None)
def _granite():
    cfg = jsmoke(jget_arch("granite-3-8b"))
    jmodel = jbuild(cfg, JCtx(tp=T, mode="coded", code_r=R))
    jparams = _np(jax.jit(lambda k: jmodel.encode_offline(jmodel.init(k)))(
        jax.random.PRNGKey(0)))
    model = build(smoke_config(get_arch("granite-3-8b")),
                  TPCtx(tp=T, mode="coded", code_r=R))
    return jmodel, jparams, model


def _batch(vocab: int, b: int = 4, s: int = 16, step: int = 0) -> dict:
    dcfg = tdata.DataConfig(vocab=vocab, seq_len=s, global_batch=b, seed=7)
    return {"tokens": tdata._synthetic_batch(dcfg, step)}


@functools.lru_cache(maxsize=None)
def _reference(n_mb: int, dead: bool):
    """The reference's loss and gradient on ``_batch`` (its microbatches
    averaged as its train step accumulates them), and its losses and
    params over three train steps. Rematerialisation does not change the
    reference's numbers, so one reference run (remat "none") serves every
    remat policy of the port."""
    jmodel, jparams, _ = _granite()
    tcfg = jtrain.TrainConfig(microbatches=n_mb, remat="none")
    loss_fn = jtrain.make_loss_fn(jmodel, tcfg)
    v = jnp.asarray(DEAD2) if dead else None
    batch = _batch(jmodel.cfg.vocab)
    b = batch["tokens"].shape[0] // n_mb
    mbs = [{"tokens": jnp.asarray(batch["tokens"][i * b:(i + 1) * b])}
           for i in range(n_mb)]

    def mean_loss(p):
        return sum(loss_fn(p, mb, v) for mb in mbs) / n_mb
    jp = jax.tree.map(jnp.asarray, jparams)
    loss, grads = jax.jit(jax.value_and_grad(mean_loss))(jp)
    step = jax.jit(jtrain.make_train_step(
        jmodel, jadamw.AdamWConfig(**OPT), tcfg))
    state, losses = jadamw.init_state(jp), []
    for i in range(3):
        jp, state, m = step(jp, state, {"tokens": jnp.asarray(
            _batch(jmodel.cfg.vocab, step=i)["tokens"])}, v)
        losses.append(float(m["loss"]))
    return float(loss), _jnamed(grads), losses, _jnamed(jp)


OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)


@pytest.mark.parametrize("remat,n_mb,dead", [
    ("none", 1, False), ("full", 1, False), ("dots", 1, False),
    ("none", 2, False), ("full", 2, False), ("dots", 2, False),
    ("full", 1, True), ("dots", 1, True)])
def test_train_step_matches_the_reference(remat, n_mb, dead):
    """Smoke granite, coded T = 4, r = 2 folded: the loss within 1e-5 and
    every gradient leaf within 1e-4 of jax.value_and_grad's (parity leaves
    included: zeros with no mask, real gradients with shard 2 dead), then
    three train steps whose losses and params stay within 1e-4."""
    _, jparams, model = _granite()
    valid = DEAD2 if dead else None
    tcfg = TrainConfig(microbatches=n_mb, remat=remat)
    jloss, jg, jlosses, jp = _reference(n_mb, dead)
    params = params_from_jax(jparams, model.ctx, device="cpu")

    loss, grads = make_grad_fn(model, tcfg)(params, _batch(model.cfg.vocab),
                                            valid)
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    got = _named_np(grads)
    for name, want in jg.items():
        if name not in got:        # the loss never read it: zeros
            assert name.endswith("/cdc") and not dead, name
            np.testing.assert_array_equal(want, 0.0, err_msg=name)
            continue
        np.testing.assert_allclose(got[name], want, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    if dead:
        assert "lm_head/cdc" in got and np.abs(got["lm_head/cdc"]).max() > 0

    step = make_train_step(model, tadamw.AdamWConfig(**OPT), tcfg)
    state = tadamw.init_state(params)
    for i, want in enumerate(jlosses):
        params, state, m = step(params, state,
                                _batch(model.cfg.vocab, step=i), valid)
        assert float(m["loss"]) == pytest.approx(want, rel=1e-4)
    got = _named_np(params)
    for name, want in jp.items():
        np.testing.assert_allclose(got[name], want, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    assert not any(p.requires_grad for _, p in named_leaves(params))


def test_training_through_a_failure_matches_fault_free():
    """The reference's case (tests/test_serve_and_train.py): with shard 2
    dead the loss is within 1e-3 of the fault-free loss and every gradient
    is finite."""
    _, jparams, model = _granite()
    params = params_from_jax(jparams, model.ctx, device="cpu")
    loss_fn = ttrain.make_loss_fn(model, TrainConfig(remat="none"))
    batch = _batch(model.cfg.vocab, b=2, s=8)
    with torch.no_grad():
        ok = float(loss_fn(params, batch))
    loss, grads = ttrain.value_and_grad(loss_fn, params, batch, DEAD2)
    assert abs(ok - float(loss)) < 1e-3
    assert all(torch.isfinite(g).all() for _, g in named_leaves(grads)
               if g is not None)


# ------------------------------------------------------------ checkpoint ----

def _train_tree(jparams, model):
    """A {"params", "opt"} tree of both packages (the port's from the same
    numbers) and a bf16 leaf."""
    rng = np.random.default_rng(4)
    jp = jax.tree.map(jnp.asarray, jparams)
    jstate = jadamw.init_state(jp)
    jstate = dict(jstate, step=jnp.asarray(5, jnp.int32),
                  mu=jax.tree.map(lambda m: m + 0.5, jstate["mu"]))
    bf = rng.normal(size=(3, 8)).astype(np.float32)
    jtree = {"params": jp, "opt": jstate,
             "extra": {"bf": jnp.asarray(bf, jnp.bfloat16)}}
    params = params_from_jax(jparams, model.ctx, device="cpu")
    tstate = tadamw.init_state(params)
    tstate["step"].fill_(5)
    for m in jax.tree.leaves(tstate["mu"]):
        m.add_(0.5)
    ttree = {"params": params, "opt": tstate,
             "extra": {"bf": torch.as_tensor(bf).to(torch.bfloat16)}}
    return jtree, ttree


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A checkpoint written by the port restores in the reference, and one
    written by the reference restores in the port: every leaf equal, the
    manifests alike, parity leaves dropped and re-encoded from the
    restored weights (bf16 stored as uint16 both ways)."""
    jmodel, jparams, model = _granite()
    jtree, ttree = _train_tree(jparams, model)
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "ref")
    tckpt.save(ttree, tdir, 3)
    jckpt.save(jtree, jdir, 3)
    tman = open(os.path.join(tdir, "step_00000003", "manifest.json")).read()
    jman = open(os.path.join(jdir, "step_00000003", "manifest.json")).read()
    assert tman == jman

    # templates of zeros: every restored value comes from the file
    jtmpl = jax.tree.map(jnp.zeros_like, jtree)
    got_j = jckpt.restore(jtmpl, tdir, 3, encode_ctx=jmodel.ctx)
    ttmpl = {"params": jax.tree.map(torch.zeros_like, ttree["params"]),
             "opt": jax.tree.map(torch.zeros_like, ttree["opt"]),
             "extra": {"bf": torch.zeros_like(ttree["extra"]["bf"])}}
    got_t = tckpt.restore(ttmpl, jdir, device="cpu", encode_ctx=model.ctx)
    want = _jnamed(jax.tree.map(lambda x: np.asarray(x, np.float32)
                                if x.dtype == jnp.bfloat16 else x, jtree))
    port = {n: (x.float() if x.dtype == torch.bfloat16 else x).numpy()
            for n, x in named_leaves(got_t)}
    ref = {n: np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 else
           np.asarray(x) for n, x in _jnamed(got_j).items()}
    assert got_t["extra"]["bf"].dtype == torch.bfloat16
    assert ref.keys() == port.keys() == want.keys()
    for name, w in want.items():
        if name.endswith("/cdc"):
            continue
        np.testing.assert_array_equal(port[name], w, err_msg=name)
        np.testing.assert_array_equal(ref[name], w, err_msg=name)
    # parity re-encoded from the restored weights in both packages
    tenc = encode_tree(params_from_jax(jparams, model.ctx, device="cpu"),
                       model.ctx)
    for name, w in _named_np(tenc).items():
        if name.endswith("/cdc"):
            np.testing.assert_allclose(port["params/" + name], w, rtol=1e-6,
                                       atol=1e-6, err_msg=name)
            np.testing.assert_allclose(ref["params/" + name], w, rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def test_async_checkpointer_keeps_host_copies_and_gc(tmp_path):
    """The async save copies each leaf before it returns: a later in-place
    update does not reach the file; three newest steps are kept."""
    x = torch.arange(6, dtype=torch.float32)
    ck = tckpt.AsyncCheckpointer(str(tmp_path), keep=3)
    for step in range(1, 6):
        ck.save({"w": x, "p": {"cdc": x}}, step)
        x.add_(100.0)
    ck.close()
    assert sorted(os.listdir(tmp_path)) == [f"step_{s:08d}"
                                            for s in (3, 4, 5)]
    got = tckpt.restore({"w": torch.zeros(6), "p": {"cdc": torch.ones(6)}},
                        str(tmp_path), 3)
    np.testing.assert_array_equal(got["w"].numpy(), np.arange(6) + 200.0)
    np.testing.assert_array_equal(got["p"]["cdc"].numpy(), np.ones(6))
    assert tckpt.latest_step(str(tmp_path)) == 5


# --------------------------------------------------------------- trainer ----

def _danube_trainer(ckpt_dir, steps, ckpt_every, log_every):
    cfg = smoke_config(get_arch("h2o-danube-1.8b"))
    model = build(cfg, TPCtx())
    return Trainer(
        model, TrainerConfig(steps=steps, ckpt_dir=ckpt_dir,
                             ckpt_every=ckpt_every, log_every=log_every,
                             device="cpu"),
        tadamw.AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=60,
                           schedule="constant", weight_decay=0.0),
        TrainConfig(microbatches=1, remat="none"),
        tdata.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))


def test_trainer_loss_decreases_and_resumes(tmp_path):
    """As the reference's test: h2o-danube at smoke size, 30 steps whose
    loss falls, a checkpoint at step 30, and a second trainer that resumes
    there and runs to step 36."""
    ckpt_dir = str(tmp_path / "ck")
    out1 = _danube_trainer(ckpt_dir, 30, 15, 1).run()
    losses = [l for _, l in out1["losses"]]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert os.path.isdir(os.path.join(ckpt_dir, "step_00000030"))
    out2 = _danube_trainer(ckpt_dir, 36, 100, 2).run(resume=True)
    assert out2["final_step"] == 36
    assert [s for s, _ in out2["losses"]] == [32, 34, 36]


def test_resume_reencodes_the_parity_and_continues_the_losses(tmp_path):
    """Coded smoke granite: steps 3-4 after a resume from step 2 give the
    uninterrupted run's losses, and the resumed params' parity is the
    encode of their weights."""
    cfg = smoke_config(get_arch("granite-3-8b"))
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R))

    def trainer(d, steps):
        return Trainer(model, TrainerConfig(steps=steps, ckpt_dir=d,
                                            ckpt_every=2, log_every=1,
                                            device="cpu"),
                       tadamw.AdamWConfig(lr=3e-3, warmup_steps=2,
                                          total_steps=4),
                       TrainConfig(remat="full"),
                       tdata.DataConfig(vocab=cfg.vocab, seq_len=16,
                                        global_batch=4))
    full = trainer(str(tmp_path / "a"), 4).run(resume=False)
    os.makedirs(tmp_path / "b")
    os.replace(tmp_path / "a" / "step_00000002",
               tmp_path / "b" / "step_00000002")
    t2 = trainer(str(tmp_path / "b"), 4)
    params, opt_state, start = t2.maybe_resume(*t2.init_state())
    assert start == 2 and int(opt_state["step"]) == 2
    enc = _named_np(encode_tree(dict(params), model.ctx))
    for name, p in _named_np(params).items():
        np.testing.assert_array_equal(p, enc[name], err_msg=name)
    resumed = t2.run(resume=True)
    assert [s for s, _ in resumed["losses"]] == [3, 4]
    for (s, l), (s0, l0) in zip(resumed["losses"], full["losses"][2:]):
        assert s == s0 and l == pytest.approx(l0, rel=1e-5)


def test_sigterm_saves_and_stops(tmp_path):
    """A SIGTERM during a step: the trainer finishes the step, saves it
    synchronously and stops."""
    ckpt_dir = str(tmp_path / "ck")
    tr = _danube_trainer(ckpt_dir, 30, 100, 1)
    step_fn, calls = tr.step_fn, []

    def preempted(*a):
        calls.append(1)
        if len(calls) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return step_fn(*a)

    tr.step_fn = preempted
    old = signal.getsignal(signal.SIGTERM)
    out = tr.run(resume=False)
    assert signal.getsignal(signal.SIGTERM) == old
    assert len(calls) == 3 and out["final_step"] == 3
    assert tckpt.latest_step(ckpt_dir) == 3


def test_launch_train_on_cpu_prints_the_csv(tmp_path, capsys):
    out = tlaunch.main(["--smoke", "--coded", "--device", "cpu", "--steps",
                        "10", "--no-resume", "--ckpt-dir",
                        str(tmp_path / "ck")])
    text = capsys.readouterr().out
    assert "step,loss" in text and "# wall:" in text
    assert [s for s, _ in out["losses"]] == [5, 10]
    assert tckpt.latest_step(str(tmp_path / "ck")) == 10
