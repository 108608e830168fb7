"""The port's distribution layer (``repro_torch.dist``) across real
processes, against the reference's single-device equivalents.

The reference's own multi-device tests run on fake XLA host devices; here
each rank is a process of a ``torch.distributed`` gloo world on the CPU
(``dist.spawn_world``), one intra-op thread a rank. The rank programs live
in ``tests/_torch_dist.py`` (torch and repro_torch only); this process
computes the reference's results with jax and hands the ranks their
inputs as numpy. Three worlds: one of 4 ranks runs every case (the coded
GEMM, the expert-parallel MoE, ``Model.forward`` with a mesh, the
pipeline, the save from the world), one of 2 ranks restores, one of 2
ranks fails on purpose; and one rank alone passes its deadline.

Held against the reference: ``param_specs`` / ``state_specs`` /
``batch_spec`` of all ten configs on four meshes, leaf for leaf by the
reference's names; the health controller's mesh placement;
``coded_matmul_shardmap`` within 1e-4 of ``core.coded_matmul`` and 2e-3 of
``x @ w`` (its triple-equivalence property) with NaN in the dead rank's
messages; ``_moe_sharded`` within 1e-5 of ``_moe_local``; qwen2-moe's
``forward`` on (data 2, model 2) within 2e-3 of the single-device one;
``pipeline_apply`` within 1e-4 of the sequential scan; a checkpoint saved
from 4 ranks restoring, to the bit, onto one process and onto 2 ranks.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dist as worker
from repro.ckpt import restore as jrestore
from repro.configs import all_archs, get_arch as jget_arch
from repro.configs import smoke_config as jsmoke
from repro.core import CodedDenseSpec as JSpec, CodeSpec as JCode
from repro.core import coded_matmul as jcoded_matmul
from repro.core import make_parity_weights as jparity
from repro.dist import pipeline as jpipeline
from repro.dist import sharding as jsharding
from repro.models import TPCtx as JCtx, build as jbuild
from repro.models import ffn as jffn
from repro.runtime import health as jhealth
from repro_torch.ckpt import restore
from repro_torch.configs import get_arch, smoke_config
from repro_torch.dist import (Mesh, batch_spec, param_specs, spawn_world,
                              state_specs)
from repro_torch.dist.sharding import local_shard, paired_leaves
from repro_torch.dist.world import RankFailed
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import TPCtx, build
from repro_torch.runtime import health
from repro_torch.tree import named_leaves

GEMM_TOL = dict(rtol=1e-4, atol=1e-4)
PLAIN_TOL = dict(rtol=2e-3, atol=2e-3)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = {"data2-model4": ((2, 4), ("data", "model")),
          "pod2-data2-model2": ((2, 2, 2), ("pod", "data", "model")),
          "model4": ((4,), ("model",)),
          "data4": ((4,), ("data",))}
QWEN2 = "qwen2-moe-a2.7b"
WORLD_S = 120.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- layout ----

def _jnames(tree, is_leaf=None):
    """{reference leaf name: leaf} of a reference pytree."""
    flat = jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)
    return {"/".join(jsharding._path_names(p)): x for p, x in flat}


def _port_specs(tree, specs):
    return {name: spec for (name, _), (_, spec) in
            zip(named_leaves(tree), paired_leaves(tree, specs))}


@functools.lru_cache(maxsize=None)
def _models(name: str):
    """(port model, its params on the CPU, reference model, its params'
    shapes) of ``name`` at smoke size, coded at T = 4."""
    cfg, jcfg = smoke_config(get_arch(name)), jsmoke(jget_arch(name))
    ctx = dict(tp=4, mode="coded", code_r=2)
    model, jmodel = build(cfg, TPCtx(**ctx)), jbuild(jcfg, JCtx(**ctx))
    return (model, model.init(0, device="cpu"), jmodel,
            jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0))))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(all_archs()))
def test_param_specs_match_reference(name, mesh_name):
    """Every param leaf of every config (coded, T = 4) gets the reference's
    spec on each mesh, FSDP over data and replicated (the serving layout),
    and both trees name the same leaves."""
    _, params, _, jparams = _models(name)
    mesh = Mesh(*MESHES[mesh_name])
    for fsdp in ("data", None):
        want = _jnames(jsharding.param_specs(jparams, mesh, fsdp=fsdp),
                       is_leaf=lambda x: isinstance(x, P))
        got = _port_specs(params, param_specs(params, mesh, fsdp=fsdp))
        assert sorted(got) == sorted(want)
        assert {k: tuple(v) for k, v in want.items()} == got, (name, fsdp)
        if fsdp or "model" in mesh.axis_names:
            assert any(any(a is not None for a in s) for s in got.values())


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(all_archs()))
def test_state_specs_match_reference(name, mesh_name):
    """The decode state (4 rows) puts its batch dim over pod + data where
    those divide it, as the reference's per-row state does: leaf for leaf
    by the reference's names. No leaf's layout differs: the port's
    heads-major KV rings keep the reference's shapes ([L, B, C, Hkv, hd],
    a transposed view), and hymba's {"kv", "mamba"} and whisper's bank
    are the reference's trees with the batch on dim 1."""
    model, _, jmodel, jparams = _models(name)
    mesh = Mesh(*MESHES[mesh_name])
    b, max_len = 4, 16
    state = model.empty_decode(b, max_len, device="cpu")
    jbatch = {"tokens": jax.ShapeDtypeStruct((b, max_len), jnp.int32)}
    if jmodel.cfg.is_encdec:
        jbatch["frames"] = jax.ShapeDtypeStruct(
            (b, jmodel.cfg.enc_seq, jmodel.cfg.d_model), jnp.float32)
    jstate = jax.eval_shape(
        lambda p, bt: jmodel.init_decode(p, bt, b, max_len, jnp.float32,
                                         per_row=True), jparams, jbatch)
    want = {k: tuple(v) for k, v in _jnames(
        jsharding.state_specs(jstate, mesh),
        is_leaf=lambda x: isinstance(x, P)).items()}
    got = _port_specs(state, state_specs(state, mesh))
    assert sorted(got) == sorted(want)
    assert got == want
    if mesh_name != "model4":
        assert any(s for s in got.values())


def test_batch_spec_and_production_meshes():
    for shape, axes in MESHES.values():
        mesh = Mesh(shape, axes)
        assert batch_spec(mesh) == tuple(jsharding.batch_spec(mesh))
        assert jsharding.batch_axes(mesh) == \
            __import__("repro_torch.dist", fromlist=["x"]).batch_axes(mesh)
    prod = make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    pods = make_production_mesh(multi_pod=True)
    assert tuple(pods.axis_names) == ("pod", "data", "model")
    assert pods.devices.shape == (2, 16, 16)
    t = make_test_mesh(2, 2, pod=2)
    assert t.lines("model") == [(0, 1), (2, 3), (4, 5), (6, 7)]
    assert t.lines(("pod", "data")) == [(0, 2, 4, 6), (1, 3, 5, 7)]
    assert t.coords(5) == {"pod": 1, "data": 0, "model": 1}


@pytest.mark.parametrize("mesh_name", ["data2-model4", "pod2-data2-model2"])
def test_health_placement_matches_reference(mesh_name):
    """shard_devices / device_mask / dead_devices on the port's mesh equal
    the reference's (given the same mesh) for every single dead shard."""
    mesh = Mesh(*MESHES[mesh_name])
    T = mesh.shape["model"]
    ctrl = health.ShardHealthController(T, 1)
    jctrl = jhealth.ShardHealthController(T, 1)
    for dead in range(T):
        ctrl.apply(health.erasure(0.0, dead))
        jctrl.apply(jhealth.erasure(0.0, dead))
        assert {i: tuple(map(int, d)) for i, d in
                ctrl.shard_devices(mesh).items()} == \
            {i: tuple(map(int, d)) for i, d in
             jctrl.shard_devices(mesh).items()}
        np.testing.assert_array_equal(ctrl.device_mask(mesh),
                                      jctrl.device_mask(mesh))
        got = tuple(map(int, ctrl.dead_devices(mesh)))
        assert got == tuple(map(int, jctrl.dead_devices(mesh)))
        assert len(got) == mesh.size // T
        ctrl.apply(health.recovery(1.0, dead))
        jctrl.apply(jhealth.recovery(1.0, dead))
    with pytest.raises(ValueError, match="size"):
        health.ShardHealthController(T + 1, 1).device_mask(mesh)


# ------------------------------------------------- the 4-rank world ----

def _gemm_cases() -> list[dict]:
    """Random coded GEMMs (the reference property's draws): T = 4 on
    (model 4) and T = 2 on (data 2, model 2), both layouts, r in {1, 2},
    masks within the budget; plus every single dead rank at T = 4, r = 2
    folded."""
    rng = np.random.default_rng(0)
    draws = [(T, r, layout) for T in (4, 2) for r in (1, 2)
             for layout in ("folded", "dedicated")]
    draws += [(4, 2, "folded")] * 4
    cases = []
    for i, (T, r, layout) in enumerate(draws):
        spec = JSpec(JCode(T, r), layout=layout)
        b = int(rng.integers(1, 6)) if i % 3 else 4
        k = int(rng.integers(1, 41))
        m = T * T * int(rng.integers(1, 3)) * 2
        x = rng.standard_normal((b, k)).astype(np.float32)
        w = (rng.standard_normal((k, m)) / max(k, 1) ** 0.5).astype(
            np.float32)
        valid = np.ones(T, bool)
        if i >= len(draws) - 4:
            valid[i - (len(draws) - 4)] = False     # every single dead rank
        else:     # the dedicated budget in full, folded at random
            n_dead = spec.max_device_failures if layout == "dedicated" \
                else int(rng.integers(0, r + 1))
            valid[rng.permutation(T)[:min(n_dead,
                                          spec.max_device_failures)]] = False
        mesh = ((4,), ("model",)) if T == 4 else ((2, 2), ("data", "model"))
        w_cdc, want = _jcoded(spec)(x, w, valid)
        cases.append(dict(T=T, r=r, layout=layout, x=x, w=w,
                          w_cdc=np.asarray(w_cdc), valid=valid, mesh=mesh[0],
                          axes=mesh[1], want=np.asarray(want), plain=x @ w))
    return cases


@functools.lru_cache(maxsize=None)
def _jcoded(spec):
    """The reference's offline encode and coded GEMM, jitted (one compile a
    shape instead of one an op)."""
    return jax.jit(lambda x, w, v: (lambda c: (c, jcoded_matmul(
        x, w, c, spec, v)))(jparity(w, spec)))


@functools.lru_cache(maxsize=None)
def _qwen2(tp: int, capacity: float = 0.0):
    jmodel = jbuild(jsmoke(jget_arch(QWEN2)),
                    JCtx(tp=tp, moe_capacity=capacity))
    return jmodel, jax.jit(jmodel.init)(jax.random.PRNGKey(0))


def _moe_layer(jparams) -> dict:
    moe = jparams["layers"]["moe"]
    return {"router": {"w": np.asarray(moe["router"]["w"][0])},
            **{n: np.asarray(moe[n][0]) for n in ("we1", "we2", "we3")}}


def _moe_cases() -> list[dict]:
    """qwen2-moe's first layer (smoke: 8 experts, top-2): capacity 0 on
    (model 4), tokens replicated, experts whole and as the rank's block;
    capacity 1.25 on (data 2, model 2), the tokens split over data."""
    jmodel, jparams = _qwen2(4)
    p = _moe_layer(jparams)
    e, k = p["we1"].shape[0], jmodel.cfg.top_k
    rng = np.random.default_rng(1)
    x = rng.standard_normal((24, jmodel.cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    local = {cap: jax.jit(functools.partial(
        jffn._moe_local, JCtx(tp=4, moe_capacity=cap), e=e, k=k))
        for cap in (0.0, 1.25)}
    cases = []
    for cap, mesh, local_experts in ((0.0, ((4,), ("model",)), False),
                                     (0.0, ((4,), ("model",)), True),
                                     (1.25, ((2, 2), ("data", "model")),
                                      True)):
        blocks = [x] if cap == 0 else np.split(x, 2)   # data blocks
        want = [np.asarray(local[cap](jp, jnp.asarray(xb)))
                for xb in blocks]
        cases.append(dict(params=p, x=x, k=k, capacity=cap, mesh=mesh[0],
                          axes=mesh[1], local_experts=local_experts,
                          want=want))
    return cases


def _forward_case() -> dict:
    jmodel, jparams = _qwen2(2)
    tokens = np.random.default_rng(2).integers(0, jmodel.cfg.vocab, (4, 8))
    return dict(arch=QWEN2, tp=2, mesh=(2, 2), axes=("data", "model"),
                params=jax.tree.map(np.asarray, jparams), tokens=tokens,
                want=np.asarray(jax.jit(jmodel.forward)(
                    jparams, {"tokens": tokens})))


def _pipeline_case() -> dict:
    rng = np.random.default_rng(3)
    L, D = 8, 32
    params = {"w": (rng.standard_normal((L, D, D)) / D ** 0.5).astype(
        np.float32), "b": (0.1 * rng.standard_normal((L, D))).astype(
        np.float32)}
    x = rng.standard_normal((8, 4, D)).astype(np.float32)

    def layer(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    seq = jpipeline.pipeline_apply(layer, jax.tree.map(jnp.asarray, params),
                                   jnp.asarray(x), mesh=Mesh((1,), ("data",)),
                                   n_microbatches=4)
    return dict(params=params, x=x, want=np.asarray(seq))


def _save_params():
    """h2o-danube-1.8b at smoke size, coded at T = 2 (the reference's
    elastic test's model), its parity re-encoded."""
    jmodel = jbuild(jsmoke(jget_arch("h2o-danube-1.8b")),
                    JCtx(tp=2, mode="coded", code_r=2))
    jparams = jax.jit(lambda key: jmodel.encode_offline(jmodel.init(key)))(
        jax.random.PRNGKey(0))
    return jmodel, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4-rank world's results, with the cases they answer."""
    ckpt = str(tmp_path_factory.mktemp("ckpt_from_world"))
    jmodel, params = _save_params()
    cases = {"gemm": _gemm_cases(), "moe": _moe_cases(),
             "forward": _forward_case(), "pipeline": _pipeline_case(),
             "save": dict(params=params, mesh=(2, 2), axes=("data", "model"),
                          dir=ckpt, step=3)}
    to_ranks = {
        "gemm": [{k: v for k, v in c.items() if k not in ("want", "plain")}
                 for c in cases["gemm"]],
        "moe": [{k: v for k, v in c.items() if k != "want"}
                for c in cases["moe"]],
        "forward": {k: v for k, v in cases["forward"].items()
                    if k != "want"},
        "pipeline": {k: v for k, v in cases["pipeline"].items()
                     if k != "want"},
        "save": cases["save"]}
    out = spawn_world(worker.world_main, 4, backend="gloo", device="cpu",
                      timeout_s=WORLD_S, args=(to_ranks,))
    return cases, out, jmodel, params, ckpt


def _rank_rows(case_mesh, case_axes, rank, n_rows):
    """The rows of an [n_rows, ...] output rank ``rank`` holds: its block
    over the non-model batch axes where they divide n_rows."""
    mesh = Mesh(case_mesh, case_axes)
    b_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    parts = 1
    for a in b_axes:
        parts *= mesh.shape[a]
    if parts <= 1 or n_rows % parts:
        return slice(None)
    c = mesh.coords(rank)
    part = 0
    for a in b_axes:
        part = part * mesh.shape[a] + c[a]
    n = n_rows // parts
    return slice(part * n, (part + 1) * n)


@pytest.mark.parametrize("i", range(12))
def test_coded_gemm_across_ranks_matches_reference(world, i):
    """Each rank's block within 1e-4 of the reference's single-device coded
    GEMM and 2e-3 of x @ w: the dead rank sent NaN, none reached an
    output."""
    cases, out, *_ = world
    c = cases["gemm"][i]
    for rank in range(4):
        got = out[rank]["gemm"][i]
        rows = _rank_rows(c["mesh"], c["axes"], rank, c["x"].shape[0])
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, c["want"][rows], **GEMM_TOL)
        np.testing.assert_allclose(got, c["plain"][rows], **PLAIN_TOL)
    if c["T"] == 2 and c["x"].shape[0] % 2 == 0:
        assert out[0]["gemm"][i].shape[0] == c["x"].shape[0] // 2


def test_gemm_cases_cover_the_masks(world):
    cases, *_ = world
    dead = [int((~c["valid"]).sum()) for c in cases["gemm"]]
    assert max(dead) == 2 and 0 in dead
    assert sorted(int(np.flatnonzero(~c["valid"])[0])
                  for c in cases["gemm"][-4:]) == [0, 1, 2, 3]


@pytest.mark.parametrize("i", range(3))
def test_moe_sharded_matches_reference_local(world, i):
    """``_moe_sharded``: every rank of a data block within 1e-5 of the
    reference's ``_moe_local`` on that block's tokens alone (capacity 0:
    all tokens; 1.25: the rank's data block)."""
    cases, out, *_ = world
    c = cases["moe"][i]
    mesh = Mesh(c["mesh"], c["axes"])
    for rank in range(4):
        block = mesh.coords(rank).get("data", 0) if c["capacity"] else 0
        np.testing.assert_allclose(out[rank]["moe"][i], c["want"][block],
                                   **MOE_TOL)


def test_model_forward_on_a_mesh_matches_single_device(world):
    """qwen2-moe's forward with ctx.mesh (data 2, model 2): the MoE layers
    expert-parallel (4 of 8 experts a rank, tokens split over data, one
    all-reduce), every rank's logits within 2e-3 of the reference's
    single-device forward."""
    cases, out, *_ = world
    for rank in range(4):
        np.testing.assert_allclose(out[rank]["forward"],
                                   cases["forward"]["want"], **PLAIN_TOL)


def test_pipeline_matches_sequential_scan(world):
    """4 stages of 2 tanh layers, 4 microbatches: every rank's result
    within 1e-4 of the reference's sequential scan; L % S and B % n_mb
    refused."""
    cases, out, *_ = world
    for rank in range(4):
        res = out[rank]["pipeline"]
        np.testing.assert_allclose(res["y"], cases["pipeline"]["want"],
                                   rtol=1e-4, atol=1e-4)
        assert "not divisible by 4 stages" in res["layers"]
        assert "not divisible by 4 microbatches" in res["batch"]


def test_world_moved_messages(world):
    _, out, *_ = world
    for rank in range(4):
        c = out[rank]["counts"]
        assert c["calls"] > 0 and c["sent"] > 0 and c["received"] > 0
        assert c["staged"] == 0            # CPU tensors: nothing staged


# ------------------------------------------------ the elastic restore ----

def test_save_from_world_restores_onto_one_process(world):
    """The blocks gathered back equal the params on every rank; rank 0
    wrote the reference's format, which the reference restores; the port
    restores it onto one process, every leaf equal to the bit."""
    cases, out, jmodel, params, ckpt = world
    assert all(o["save"]["gathered_equal"] for o in out)
    assert out[0]["save"]["n_sharded"] > 10
    template = jax.tree.map(jnp.zeros_like, params)
    ref = jax.tree.map(np.asarray, jrestore(template, ckpt, 3))
    ctx = TPCtx(tp=2, mode="coded", code_r=2)
    tmpl = jax.tree.map(lambda a: torch.zeros(a.shape), params)
    got = restore(tmpl, ckpt, 3, device="cpu", encode_ctx=ctx)
    want = dict(_jnames(ref))
    for name, leaf in named_leaves(got):
        if name.endswith("/cdc"):
            np.testing.assert_allclose(leaf.numpy(), dict(_jnames(params))[
                name], rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(leaf.numpy(), want[name])
            np.testing.assert_array_equal(leaf.numpy(),
                                          dict(_jnames(params))[name])


def test_restore_onto_a_two_rank_world(world):
    """The checkpoint saved from (data 2, model 2) restores onto (model 2):
    each rank holds its own block of every leaf, equal to the bit to that
    block of the reference's restore; the parity re-encoded from the whole
    weight, then cut, within 1e-5 of the reference's parity's block."""
    cases, out, jmodel, params, ckpt = world
    mesh = Mesh((2,), ("model",))
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), params)
    ranks = spawn_world(worker.restore_main, 2, backend="gloo", device="cpu",
                        timeout_s=WORLD_S,
                        args=(dict(template=template, dir=ckpt, step=3,
                                   mesh=(2,), axes=("model",), tp=2),))
    ref = dict(_jnames(jax.tree.map(np.asarray, jrestore(
        jax.tree.map(jnp.zeros_like, params), ckpt, 3))))
    full = dict(_jnames(params))
    specs = _port_specs(template, param_specs(template, mesh, fsdp=None))
    assert any(any(a is not None for a in s) for s in specs.values())
    for rank, got in enumerate(ranks):
        assert sorted(got) == sorted(full)
        for name, leaf in got.items():
            src = full if name.endswith("/cdc") else ref
            want = local_shard(src[name], specs[name], mesh, rank)
            if name.endswith("/cdc"):
                np.testing.assert_allclose(leaf, want, rtol=1e-5, atol=1e-5)
            else:
                assert leaf.shape == want.shape
                np.testing.assert_array_equal(leaf, want)


# --------------------------------------------------------- failures ----

def test_a_rank_that_raises_fails_the_world():
    """Rank 1 raises while rank 0 waits on it: spawn_world raises with rank
    1's traceback within the deadline, and no rank is left running."""
    with pytest.raises(RankFailed, match="(?s)rank 1 of 2 failed first.*"
                                         "rank 1 fails on purpose"):
        spawn_world(worker.raising_main, 2, backend="gloo", device="cpu",
                    timeout_s=WORLD_S)


def test_a_world_past_its_deadline_is_killed():
    with pytest.raises(TimeoutError, match="deadline"):
        spawn_world(worker.hanging_main, 1, backend="gloo", device="cpu",
                    timeout_s=3.0)
