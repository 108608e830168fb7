"""``Trainer(mesh=)`` over a world of ranks against the reference's
unsharded train step and against the port's single-process trainer.

One spawned gloo world of 4 ranks (``dist.spawn_world``, on the CPU; the
rank programs live in tests/_torch_train_mesh.py, which imports no jax)
trains smoke granite, coded at T = 4, r = 2 folded, on the mesh (data 2,
model 2): three steps fault-free, with 2 microbatches, and with shard 2
dead; a resume from the step-2 checkpoint on a second mesh (data 4,
model 1); and a run in which SIGTERM reaches rank 1 alone. The reference
is the JAX package's train step on the same params unsharded: its own
mesh step is ``jax.jit`` of that function over sharded arrays (and the
reference's multi-device tests fail under jax 0.9), so its numbers
are the ones to hold. Checked: losses and params within 1e-4 of the
reference's, losses within 1e-5 and params within 1e-4 of the port's
single-process ``Trainer``; the blocks each rank holds between steps;
each step's message bytes, reckoned from the leaves' sizes; resumes on
another mesh and in one process continuing the losses within 1e-5; all
ranks stopping together on one rank's SIGTERM.
"""
import functools
import math

import _torch_train_mesh as worker
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
from repro.models import TPCtx as JCtx, build as jbuild
from repro.optim import adamw as jadamw
from repro.train import train_step as jtrain
from repro_torch.ckpt import latest_step
from repro_torch.data import DataConfig, make_stream
from repro_torch.dist import Mesh, comm, param_specs, spawn_world
from repro_torch.dist.sharding import (block_index, local_shard,
                                       paired_leaves)
from repro_torch.train.trainer import mesh_step_messages
from repro_torch.tree import named_leaves

DEAD2 = np.arange(worker.T) != 2
# eps 1e-6, as tests/test_torch_train_families.py sets it: Adam's step has
# slope up to 1 / eps in a gradient element, so at the default 1e-8 an
# element whose gradient cancels to ~1e-8 magnifies float-order
# differences between two correct steps beyond 1e-4
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10, eps=1e-6)
MESH = Mesh((2, 2), ("data", "model"))
WORLD_S = 600.0
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh_train") / "ck")
    out = spawn_world(worker.world_main, 4, backend="gloo", device="cpu",
                      timeout_s=WORLD_S,
                      args=({"dir": d, "opt": OPT, "dead": DEAD2},))
    return d, out


@functools.lru_cache(maxsize=None)
def _init_params():
    """The port's params from the trainer's seed (the single-process
    init every rank also runs), whole, on the CPU."""
    tr = worker.make_trainer("unused", 3, 100, OPT)
    params, _ = tr.init_state()
    return params


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_jax(v) for v in tree)
    return jnp.asarray(tree.numpy())


def _jnamed(tree) -> dict:
    paths, _ = jax.tree_util.tree_flatten_with_path(tree)

    def name(p):
        return "/".join(f"#{k.idx}" if isinstance(k, jax.tree_util.SequenceKey)
                        else str(k.key) for k in p)
    return {name(p): np.asarray(x) for p, x in paths}


def _batches(n: int = 3) -> list[np.ndarray]:
    cfg = jsmoke(jget_arch(worker.ARCH))
    stream = make_stream(DataConfig(vocab=cfg.vocab, seq_len=worker.SEQ,
                                    global_batch=worker.BATCH))
    return [next(stream)["tokens"] for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _jitted():
    """The reference's value_and_grad and AdamW update, jitted; its train
    step is these two in a row, microbatch gradients averaged in float32
    (``repro.train.train_step.make_train_step``)."""
    jmodel = jbuild(jsmoke(jget_arch(worker.ARCH)),
                    JCtx(tp=worker.T, mode="coded", code_r=worker.R))
    loss_fn = jtrain.make_loss_fn(jmodel, jtrain.TrainConfig(remat="none"))
    return (jax.jit(jax.value_and_grad(loss_fn)),
            jax.jit(functools.partial(jadamw.apply_updates,
                                      jadamw.AdamWConfig(**OPT))))


@functools.lru_cache(maxsize=None)
def _reference(n_mb: int, dead: bool):
    """The reference's three unsharded steps from the trainer's init:
    losses and params."""
    vg, update = _jitted()
    jp = _to_jax(_init_params())
    state, losses = jadamw.init_state(jp), []
    v = jnp.asarray(DEAD2) if dead else None
    for tokens in _batches():
        b = tokens.shape[0] // n_mb
        parts = [vg(jp, {"tokens": jnp.asarray(tokens[i * b:(i + 1) * b])},
                    v) for i in range(n_mb)]
        loss = sum(p[0] for p in parts) / n_mb
        grads = jax.tree.map(lambda *g: sum(x.astype(jnp.float32)
                                            for x in g) / n_mb,
                             *[p[1] for p in parts])
        jp, state, _ = update(jp, grads, state)
        losses.append(float(loss))
    return losses, _jnamed(jp)


def _single(tmp: str, n_mb: int, dead: bool):
    """The port's single-process trainer on the same settings: (losses,
    grad norms, params)."""
    tr = worker.make_trainer(tmp, 3, 100, OPT, microbatches=n_mb)
    log = worker.record(tr, DEAD2 if dead else None)
    out = tr.run(resume=False)
    return ([l for _, l in out["losses"]], log["grad_norms"],
            {n: x.numpy() for n, x in named_leaves(out["params"])})


RUNS = {"base": (1, False), "mb2": (2, False), "dead": (1, True)}


@pytest.mark.parametrize("run", list(RUNS))
def test_mesh_trainer_matches_the_reference_and_one_process(world, run,
                                                             tmp_path):
    """Three steps on (data 2, model 2): losses and the params gathered on
    rank 0 within 1e-4 of the reference's unsharded steps; against the
    port's single-process trainer, losses within 1e-5, grad norms within
    1e-5 and params within 1e-4. Every rank ends with the same losses and
    (fault-free run) the same gathered params."""
    _, out = world
    n_mb, dead = RUNS[run]
    jlosses, jp = _reference(n_mb, dead)
    slosses, snorms, sp = _single(str(tmp_path), n_mb, dead)
    got = out[0][run]
    losses = [l for _, l in got["losses"]]
    assert [s for s, _ in got["losses"]] == [1, 2, 3]
    np.testing.assert_allclose(losses, jlosses, **TOL)
    np.testing.assert_allclose(losses, slosses, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got["grad_norms"], snorms, rtol=1e-5, atol=0)
    for name, want in jp.items():
        np.testing.assert_allclose(got["params"][name], want, **TOL,
                                   err_msg=f"{run} {name}")
        np.testing.assert_allclose(got["params"][name], sp[name], **TOL,
                                   err_msg=f"{run} {name}")
    for rank in range(1, 4):
        assert out[rank][run]["losses"] == got["losses"]
    if run == "base":
        for rank in range(1, 4):
            for name, x in out[rank][run]["params"].items():
                np.testing.assert_array_equal(x, got["params"][name])


def test_each_rank_holds_only_its_blocks_between_steps(world):
    """Before and after every step a rank holds its blocks of the params
    and of mu, nu and master (the shapes ``local_shard`` gives under
    ``param_specs``, FSDP over data), and the step count whole."""
    _, out = world
    params = _init_params()
    specs = param_specs(params, MESH)
    spec_of = dict(zip([n for n, _ in named_leaves(params)],
                       _spec_leaves(params, specs)))
    for rank in range(4):
        want = {}
        for name, leaf in named_leaves(params):
            shape = tuple(local_shard(leaf, spec_of[name], MESH,
                                      rank).shape)
            want["params/" + name] = shape
            for k in ("mu", "nu", "master"):
                want[f"opt/{k}/{name}"] = shape
        want["opt/step"] = ()
        held = out[rank]["base"]["held"]
        assert len(held) == 6
        for h in held:
            assert h == want
    # some leaves really are cut, over both axes
    assert any(math.prod(p for _, p in block_index(s, MESH, 0)) == 4
               for s in spec_of.values())


def _spec_leaves(params, specs) -> list:
    return [s for _, s in paired_leaves(params, specs)]


def test_message_bytes_of_a_step_are_reckoned_exactly(world):
    """A fault-free step's ``comm.COUNTS`` on every rank, as the library's
    reckoning (``trainer.mesh_step_messages``, the dry run's collective
    record) gives it: one all-gather over the 4 ranks for each sharded
    leaf (the rank's block out, the 3 others in), one all-reduce over the
    data line for each gradient leaf the loss read (the parity leaves are
    not read fault-free) and one for the loss: sent and received bytes and
    calls exactly."""
    _, out = world
    params = _init_params()
    messages = mesh_step_messages(params, MESH,
                                  read=lambda n: not n.endswith("/cdc"))
    want = comm.counts_of(messages)
    # the reckoning spelled out from the leaves' sizes
    specs = _spec_leaves(params, param_specs(params, MESH))
    calls = sent = received = 0
    for (name, leaf), spec in zip(named_leaves(params), specs):
        nb = leaf.numel() * leaf.element_size()
        if any(a is not None for a in spec):
            blk = nb // math.prod(p for _, p in block_index(spec, MESH, 0))
            calls, sent, received = calls + 1, sent + blk, received + 3 * blk
        if not name.endswith("/cdc"):
            calls, sent, received = calls + 1, sent + nb, received + nb
    calls, sent, received = calls + 1, sent + 4, received + 4    # the loss
    assert want == {"calls": calls, "sent": sent, "received": received,
                    "staged": 0}
    for rank in range(4):
        for counts in out[rank]["base"]["counts"]:
            assert counts == want


def test_resume_on_another_mesh_and_in_one_process(world, tmp_path):
    """The step-2 checkpoint the world saved (rank 0 wrote it, gathered on
    the training thread) restores onto (data 4, model 1) in the world and
    onto one process: both continue to the uninterrupted run's step-3 loss
    within 1e-5."""
    d, out = world
    assert latest_step(d) == 2
    want = out[0]["base"]["losses"][2]
    for rank in range(4):
        got = out[rank]["resumed"]["losses"]
        assert [s for s, _ in got] == [3]
        assert got[0][1] == pytest.approx(want[1], rel=1e-5)
    one = worker.make_trainer(d, 3, 100, OPT).run(resume=True)
    assert [s for s, _ in one["losses"]] == [3]
    assert one["losses"][0][1] == pytest.approx(want[1], rel=1e-5)


def test_sigterm_on_one_rank_stops_every_rank_together(world):
    """SIGTERM reaches rank 1 alone during step 2: the ranks agree on it
    after the step, save step 2 synchronously from the world and stop."""
    d, out = world
    assert [out[r]["sigterm"] for r in range(4)] == [2, 2, 2, 2]
    assert latest_step(d + "_sig") == 2
