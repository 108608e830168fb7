"""The port's config helpers and dry run against the reference's.

Held against the JAX package: ``param_count``, ``active_param_count``,
``SHAPES`` and ``runnable`` for all ten configs, full and smoke;
``Model.input_spec`` (meta tensors of the reference's shapes and dtypes);
the dry run's parameter census (``count_params`` on meta params against
the reference's ``count_params`` of ``jax.eval_shape(init)``, every config
at full size, coded and plain, nothing allocated) and
``microbatches_for``; ``CodeSpec.total_shards`` and
``TrainConfig(aux_loss_weight=)``. Then the dry run itself: ``--smoke
--coded --mesh both --all`` ends with every cell ``ok``, and an error cell
makes it exit 1.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import all_archs as jall_archs
from repro.configs import get_arch as jget_arch, runnable as jrunnable
from repro.configs import smoke_config as jsmoke
from repro.core.coding import CodeSpec as JCodeSpec
from repro.models import TPCtx as JCtx, build as jbuild
from repro.train import train_step as jtrain
from repro_torch.configs import (PORT_ONLY, SHAPES, all_archs, get_arch,
                                 runnable, smoke_config)
from repro_torch.core.coding import CodeSpec
from repro_torch.launch import dryrun
from repro_torch.models import TPCtx, build
from repro_torch.train import TrainConfig
from repro_torch.tree import named_leaves

NAMES = sorted(jall_archs())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jdryrun():
    """The reference's dry-run module. Importing it sets XLA_FLAGS for 512
    host devices when none are set; jax's backend is started first, so
    this process keeps its devices, and the variable is put back so that
    no later subprocess inherits it."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdr
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return jdr


def test_every_config_is_registered_in_both_packages():
    """The reference's ten are in the port, field for field; the port's
    other names are exactly its declared port-only set."""
    port = all_archs()
    assert len(NAMES) == 10 and set(NAMES) <= set(port)
    assert set(port) - set(NAMES) == PORT_ONLY
    for name in NAMES:
        assert dataclasses.asdict(port[name]) == \
            dataclasses.asdict(jget_arch(name)), name


@pytest.mark.parametrize("name", NAMES)
def test_param_counts_shapes_and_runnable_match_the_reference(name):
    for cfg, jcfg in ((get_arch(name), jget_arch(name)),
                      (smoke_config(get_arch(name)), jsmoke(jget_arch(name)))):
        assert cfg.param_count == jcfg.param_count
        assert cfg.active_param_count == jcfg.active_param_count
        for shape in JSHAPES:
            assert runnable(cfg, SHAPES[shape]) == \
                jrunnable(jcfg, JSHAPES[shape])
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", ["granite-3-8b", "whisper-medium"])
def test_input_spec_matches_the_reference(name, dtype):
    """Meta tensors (no storage) of the reference's shapes and dtypes:
    int32 tokens, and whisper's frames in the dtype asked for."""
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    want = jbuild(jget_arch(name)).input_spec(4, 32, jdt)
    got = build(get_arch(name)).input_spec(4, 32, dtype)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.is_meta
        assert tuple(t.shape) == want[k].shape
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype)


@pytest.mark.parametrize("mode", ["plain", "coded"])
@pytest.mark.parametrize("name", NAMES)
def test_census_on_meta_params_equals_the_reference(name, mode):
    """``count_params`` of params built on the meta device (full size,
    T = 16 as on the production meshes, bf16: nothing allocated) equals
    the reference's of ``jax.eval_shape(init)``; the trees have the same
    leaves and shapes."""
    jdr = _jdryrun()
    jmodel = jbuild(jget_arch(name), JCtx(tp=16, mode=mode, code_r=2))
    jshape = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.bfloat16))
    model = build(get_arch(name), TPCtx(tp=16, mode=mode, code_r=2))
    with torch.no_grad():
        params = model.encode_offline(model.init(0, torch.bfloat16,
                                                 device="meta"))
    assert all(x.is_meta for _, x in named_leaves(params))
    assert dryrun.count_params(params, model.cfg) == \
        jdr.count_params(jshape, jmodel.cfg)
    assert sorted(tuple(x.shape) for _, x in named_leaves(params)) == \
        sorted(x.shape for x in jax.tree.leaves(jshape))


def test_microbatches_for_matches_the_reference():
    jdr = _jdryrun()
    shapes = {**SHAPES, **dryrun.SMOKE_SHAPES}
    jshapes = {**JSHAPES, **jdr.SMOKE_SHAPES}
    for name in NAMES:
        for cfg, jcfg in ((get_arch(name), jget_arch(name)),
                          (smoke_config(get_arch(name)),
                           jsmoke(jget_arch(name)))):
            for s in shapes:
                for n in (1, 2, 4, 16, 32):
                    assert dryrun.microbatches_for(cfg, shapes[s], n) == \
                        jdr.microbatches_for(jcfg, jshapes[s], n), (name, s)


@pytest.mark.parametrize("t,r", [(4, 2), (4, 0), (12, 3), (16, 16)])
def test_code_spec_total_shards_and_aux_loss_weight(t, r):
    assert CodeSpec(t, r).total_shards == JCodeSpec(t, r).total_shards \
        == t + r
    for w in (0.0, 0.5):
        assert TrainConfig(aux_loss_weight=w).aux_loss_weight == \
            jtrain.TrainConfig(aux_loss_weight=w).aux_loss_weight


def test_smoke_dry_run_ends_with_every_cell_ok(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --smoke --coded --mesh both
    --all``: 44 cells (the 11 registered configs, the reference's ten and
    the port's nemotron-h-47b, x 2 smoke shapes x 2 meshes) on the (2, 4)
    and (2, 2, 2) meshes, every one ``ok``, each with the census,
    rank 0's bytes and the model FLOPs; exit code 0. A second run takes
    every cell from the cache."""
    out = tmp_path / "dryrun.json"
    argv = ["--smoke", "--coded", "--mesh", "both", "--all", "--out",
            str(out)]
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv)
    assert e.value.code == 0
    n_cells = 4 * len(all_archs())
    assert n_cells == 44
    assert f"done: {n_cells} ok, 0 structured skips, 0 errors" in \
        capsys.readouterr().out
    cells = json.loads(out.read_text())
    assert len(cells) == n_cells
    assert all(rec["status"] == "ok" and rec["coded"]
               for rec in cells.values()), cells
    assert {rec["mesh"] for rec in cells.values()} == {"2x4", "pod2x2x2"}
    for key, rec in cells.items():
        cfg = smoke_config(get_arch(rec["arch"]))
        assert rec["params"]["total"] >= rec["params"]["active"] > 0
        b = rec["bytes_rank0"]
        assert b["params"] > 0
        train = rec["shape"] == "train_smoke"
        assert (b["opt_state"] > 0) == train
        assert (b["decode_state"] > 0) != train
        assert rec["model_flops"] > 0
        assert rec["microbatches"] == dryrun.microbatches_for(
            cfg, dryrun.SMOKE_SHAPES[rec["shape"]],
            4 if "pod" in rec["mesh"] else 2)
    granite = cells["granite-3-8b|train_smoke|single|coded|smoke"]
    jdr = _jdryrun()
    jcfg = jsmoke(jget_arch("granite-3-8b"))
    jmodel = jbuild(jcfg, JCtx(tp=4, mode="coded", code_r=2))
    jshape = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.bfloat16))
    active, total = jdr.count_params(jshape, jcfg)
    assert granite["params"] == {"total": total, "active": active}
    assert granite["model_flops"] == 6 * active * 8 * 64 / 8
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv)
    assert e.value.code == 0
    assert capsys.readouterr().out.count("[cached]") == n_cells


def test_an_error_cell_makes_the_dry_run_exit_1(tmp_path, monkeypatch,
                                                capsys):
    def broken(*a, **k):
        raise RuntimeError("shapes do not cohere")
    monkeypatch.setattr(dryrun, "lower_cell", broken)
    out = tmp_path / "dryrun.json"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--smoke", "--shape", "train_smoke", "--out",
                     str(out)])
    assert e.value.code == 1
    assert "done: 0 ok, 0 structured skips, 1 errors" in \
        capsys.readouterr().out
    rec = json.loads(out.read_text())["granite-3-8b|train_smoke|single|smoke"]
    assert rec["status"] == "error" and "shapes do not cohere" in \
        rec["error"]


def test_dry_run_writes_under_the_temporary_directory():
    import tempfile
    assert os.path.dirname(dryrun.DEFAULT_OUT) == tempfile.gettempdir()
