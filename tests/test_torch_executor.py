"""The port's batched slot executor (smoke size, CPU).

  * batched rounds under staggered admission (slots at different KV
    positions) give the same token streams as sequential per-request
    stepping, with and without host/device overlap, and as the
    reference package's own executor under a mid-run erasure;
  * the fused variant serves rounds with <= 1 dead shard, and a round
    with 2+ dead shards takes the reference variant.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
from repro.models import TPCtx as JCtx, build as jbuild
from repro.runtime.executor import SlotPoolExecutor as JPool
from repro.serve import ModelStepper as JStepper
from repro_torch.configs import get_arch, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import TPCtx, build
from repro_torch.runtime.metrics import RuntimeMetrics
from repro_torch.runtime.executor import (SlotPoolExecutor, read_slot,
                                          write_slot)
from repro_torch.serve import ModelStepper

T, R = 4, 2
N_SLOTS = 3


def _pair(layout="folded"):
    jcfg = jsmoke(jget_arch("granite-3-8b"))
    jmodel = jbuild(jcfg, JCtx(tp=T, mode="coded", code_r=R,
                               code_layout=layout))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = smoke_config(get_arch("granite-3-8b"))
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R,
                             code_layout=layout))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.ctx,
                             device="cpu")
    return (JStepper(jmodel, jparams, max_len=32, cache_dtype=jnp.float32),
            ModelStepper(model, params, max_len=32), cfg)


@pytest.fixture(scope="module")
def steppers():
    return _pair()


def _arrivals(cfg, n=5, gen=4):
    """(round, prompt, n_tokens): prompts of different lengths admitted at
    different rounds."""
    rng = np.random.default_rng(3)
    return [(i, rng.integers(0, cfg.vocab, 3 + i % 3), gen) for i in range(n)]


def _drive(pool, arrivals, mask_at):
    """A minimal continuous-batching loop over ``pool``: admit arrivals
    into free slots, step rounds, evict finished requests. Tokens of a
    round harvested after its request finished (overlap) are dropped, as
    the scheduler drops them."""
    queue = list(enumerate(arrivals))
    out, owner = {}, [None] * N_SLOTS
    rnd = 0
    while queue or any(o is not None for o in owner):
        valid = mask_at(rnd)
        for slot in range(N_SLOTS):
            if owner[slot] is None and queue and queue[0][1][0] <= rnd:
                rid, (_, prompt, n) = queue.pop(0)
                out[rid] = [pool.admit(slot, prompt, valid, tag=rid)]
                owner[slot] = (rid, n)
        for slot, tag, tok in pool.step_round(valid):
            if owner[slot] is None or owner[slot][0] != tag:
                continue
            out[tag].append(tok)
            if len(out[tag]) == owner[slot][1]:
                pool.evict(slot)
                owner[slot] = None
        rnd += 1
        assert rnd < 100
    return out


def _sequential(stepper, arrivals, valid):
    out = {}
    for rid, (_, prompt, n) in enumerate(arrivals):
        logits, st = stepper.prefill({"tokens": np.asarray(prompt)[None]},
                                     valid)
        tok = stepper.greedy(logits)
        toks = [int(tok[0, 0])]
        while len(toks) < n:
            logits, st = stepper.decode_one(st, tok, valid)
            tok = stepper.greedy(logits)
            toks.append(int(tok[0, 0]))
        out[rid] = toks
    return out


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
@pytest.mark.parametrize("dead", [None, 2], ids=["healthy", "shard2-dead"])
def test_batched_matches_sequential_staggered(steppers, overlap, dead):
    _, stepper, cfg = steppers
    valid = np.ones(T, bool)
    if dead is not None:
        valid[dead] = False
    arrivals = _arrivals(cfg)
    metrics = RuntimeMetrics()
    pool = SlotPoolExecutor(stepper, N_SLOTS, overlap=overlap,
                            use_fused=True, metrics=metrics)
    got = _drive(pool, arrivals, lambda r: valid)
    assert got == _sequential(stepper, arrivals, valid)
    assert pool.vstep.last_variant == "fused"
    assert metrics.round_ms.n > 0


@pytest.mark.parametrize("use_fused", [True, False],
                         ids=["fused", "reference"])
def test_batched_matches_reference_executor_with_erasure(steppers,
                                                         use_fused):
    """The same admission loop over the reference package's executor and
    the port's: identical streams with shard 1 erased from round 2 on."""
    jstepper, stepper, cfg = steppers
    arrivals = _arrivals(cfg)

    def mask_at(r):
        return np.array([True, r < 2, True, True])

    want = _drive(JPool(jstepper, N_SLOTS, overlap=True), arrivals, mask_at)
    got = _drive(SlotPoolExecutor(stepper, N_SLOTS, overlap=True,
                                  use_fused=use_fused), arrivals, mask_at)
    assert got == want


def test_two_dead_round_takes_reference_variant():
    """Dedicated r=2 tolerates 2 dead shards, beyond the fused kernels'
    one: such a round runs the reference variant, with the same tokens."""
    _, stepper, cfg = _pair("dedicated")
    prompt = np.arange(5) % cfg.vocab
    one_dead = np.array([True, False, True, True])
    two_dead = np.array([True, False, True, False])
    toks = {}
    for fused in (True, False):
        pool = SlotPoolExecutor(stepper, 1, overlap=False, use_fused=fused)
        seq = [pool.admit(0, prompt, one_dead)]
        for valid, variant in ((one_dead, "fused"), (two_dead, "reference"),
                               (one_dead, "fused")):
            seq += [t for _, _, t in pool.step_round(valid)]
            assert pool.vstep.last_variant == (variant if fused
                                               else "reference")
        toks[fused] = seq
    assert toks[True] == toks[False]


def test_write_and_read_slot_roundtrip(steppers):
    _, stepper, _ = steppers
    pool = SlotPoolExecutor(stepper, N_SLOTS, overlap=False)
    _, row = stepper.prefill({"tokens": np.array([[1, 2, 3]])},
                             np.ones(T, bool))
    write_slot(pool.state, 1, row)
    back = read_slot(pool.state, 1)
    for name in ("k", "v", "pos", "len"):
        assert torch.equal(back["kv"][name], row["kv"][name])
    assert int(pool.state["kv"]["len"][0, 0]) == 0      # other rows intact
