"""The dry run's cost, collective and roofline record against the
reference's.

Held against the JAX package: ``roofline_report`` on the same terms and
rates; ``wire_bytes`` over (kind, bytes, group size) messages against the
reference's ``collective_bytes`` on HLO text holding the same collectives
(all five kinds, several group sizes, both replica-group forms, an async
pair). Then every ``--smoke --coded`` cell on both meshes: the record holds
the reference's keys (read from the reference's ``lower_cell``, less its
XLA-only ``lower_s``, ``compile_s``, ``memory`` and unweighted XLA count),
``custom_calls_uncosted`` is 0; a train cell's roofline model FLOPs are the
cell's and its useful ratio lies in (0, 1], its collectives are the mesh
trainer's messages reckoned from the leaves' sizes, and its cost is the
counted microbatch times the microbatches plus the update; a serving cell
says null for its collectives; a cell counts the same whichever runs first.
"""
import ast
import functools
import math
from pathlib import Path

import pytest
import torch

from repro.roofline import analysis as jan
from repro_torch.configs import all_archs, get_arch, smoke_config
from repro_torch.dist import comm, param_specs
from repro_torch.dist.sharding import batch_axes, block_index, paired_leaves
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import TPCtx, build
from repro_torch.models import encdec
from repro_torch.roofline import analysis as tan
from repro_torch.tree import named_leaves

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(all_archs())
CELLS = [(a, s, mp) for a in ARCHS for s in dryrun.SMOKE_SHAPES
         for mp in (False, True)]
TRAIN = [c for c in CELLS if c[1] == "train_smoke"]
XLA_ONLY = {"lower_s", "compile_s", "memory"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell_id(c):
    return f"{c[0]}|{c[1]}|{'multi' if c[2] else 'single'}"


@functools.lru_cache(maxsize=None)
def _cell(arch, shape, multi_pod):
    return dryrun.lower_cell(arch, shape, multi_pod=multi_pod, coded=True,
                             smoke=True, verbose=False)


@functools.lru_cache(maxsize=None)
def _reference_record_keys() -> dict:
    """The keys of the reference's ``lower_cell`` record, its ``cost`` and
    its ``roofline``, read from its source."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "lower_cell")
    rec = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "rec")
    keys = {k.value: v for k, v in zip(rec.keys, rec.values)}
    roof = next(n for n in ast.walk(keys["roofline"])
                if isinstance(n, ast.Tuple))
    return {"record": set(keys),
            "cost": {k.value for k in keys["cost"].keys},
            "roofline": {e.value for e in roof.elts}}


# ------------------------------------------------------------- roofline ----

TERMS = [
    {"flops": 4e12, "bytes accessed": 1e9},          # compute-bound
    {"flops": 1e9, "bytes accessed": 4e11},          # memory-bound
    {"flops": 1e6, "bytes accessed": 1e6},           # collective-bound
    {"flops": 0.0, "bytes accessed": 0.0},           # nothing
]
COLL = [None, {"total": 0.0}, {"total": 1e9}, None]


@pytest.mark.parametrize("i", range(len(TERMS)))
@pytest.mark.parametrize("model_flops", [0.0, 5e11, 3e12])
def test_roofline_report_is_the_reference_s(i, model_flops):
    coll = COLL[i] or {}
    want_terms = jan.roofline_terms(TERMS[i], coll, jan.HW)
    got_terms = tan.roofline_terms(TERMS[i], coll, jan.HW)
    assert got_terms == want_terms
    assert tan.roofline_report(got_terms, model_flops, jan.HW) == \
        jan.roofline_report(want_terms, model_flops)


def test_the_rates_are_one_h100_s():
    hw = tan.hw_for(torch.bfloat16)
    assert hw == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                  "link_bw": 450e9}
    assert tan.hw_for(torch.float32)["peak_flops"] == 67e12


# ------------------------------------------------------------ wire bytes ----

_HLO_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.int32: "s32"}


def _hlo_line(i, kind, shape, dtype, k, iota: bool, op: str = "") -> str:
    dims = ",".join(map(str, shape))
    ty = f"{_HLO_TYPES[dtype]}[{dims}]"
    groups = f"replica_groups=[{8 // k if 8 % k == 0 else 1},{k}]<=[8]" \
        if iota else "replica_groups={{" + ",".join(map(str, range(k))) + \
        "}}"
    return (f"  %c.{i} = {ty}{{0}} {kind}{op}({ty}{{0}} %p.{i}), "
            f"channel_id={i}, {groups}, to_apply=%add")


@pytest.mark.parametrize("iota", [False, True], ids=["listed", "iota"])
def test_wire_bytes_is_the_reference_s_collective_bytes(iota):
    """The same collectives as messages and as HLO lines: equal bytes by
    kind, total and counts."""
    lines, messages = ["HloModule m", "ENTRY %main {"], []
    i = 0
    for kind in tan.COLLECTIVE_KINDS:
        for k in (1, 2, 4, 8):
            for shape, dtype in (((k * 3, 64), torch.float32),
                                 ((k * 5, 7), torch.bfloat16),
                                 ((k,), torch.int32)):
                i += 1
                lines.append(_hlo_line(i, kind, shape, dtype, k, iota))
                nb = math.prod(shape) * torch.tensor(
                    [], dtype=dtype).element_size()
                messages.append((kind, nb, k))
    # an async pair counts once, at its start
    lines.append(_hlo_line(999, "all-reduce", (16, 16), torch.float32, 4,
                           iota, "-start"))
    lines.append("  %d.999 = f32[16,16]{0} all-reduce-done(f32[16,16]{0} "
                 "%c.999)")
    messages.append(("all-reduce", 16 * 16 * 4, 4))
    lines.append("}")
    want = jan.collective_bytes("\n".join(lines))
    got = tan.wire_bytes(messages)
    assert got["counts"] == want["counts"]
    assert set(got) == set(want)
    for kind in (*tan.COLLECTIVE_KINDS, "total"):
        assert got[kind] == pytest.approx(want[kind], rel=1e-12), kind
    assert all(n > 0 for n in got["counts"].values())


def test_wire_bytes_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown collective"):
        tan.wire_bytes([("broadcast", 8, 2)])


# ------------------------------------------------------------ the record ----

@pytest.mark.parametrize("cell", CELLS, ids=_cell_id)
def test_every_cell_has_the_reference_s_record_keys(cell):
    rec = _cell(*cell)
    ref = _reference_record_keys()
    assert rec["status"] == "ok"
    assert ref["record"] - XLA_ONLY <= set(rec)
    assert ref["cost"] - {"xla_flops_unweighted"} <= set(rec["cost"])
    assert set(rec["roofline"]) == ref["roofline"]
    assert rec["cost"]["custom_calls_uncosted"] == 0
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes"] > 0
    hw = tan.hw_for(dryrun.DTYPE)
    roof = rec["roofline"]
    assert roof["compute_s"] == rec["cost"]["flops"] / hw["peak_flops"]
    assert roof["memory_s"] == rec["cost"]["bytes"] / hw["hbm_bw"]
    if cell[1] == "train_smoke":
        assert set(rec["collectives"]) == {*tan.COLLECTIVE_KINDS, "total"}
        assert set(rec["collective_counts"]) == set(tan.COLLECTIVE_KINDS)
        assert roof["collective_s"] == \
            rec["collectives"]["total"] / hw["link_bw"]
    else:
        assert rec["collectives"] is None
        assert rec["collective_counts"] is None
        assert roof["collective_s"] == 0.0


@pytest.mark.parametrize("cell", TRAIN, ids=_cell_id)
def test_train_cell_roofline_holds_the_cell_s_model_flops(cell):
    rec = _cell(*cell)
    roof = rec["roofline"]
    assert roof["model_flops"] == rec["model_flops"]
    assert 0 < roof["useful_ratio"] <= 1
    assert roof["useful_ratio"] == rec["model_flops"] / rec["cost"]["flops"]
    assert 0 < roof["roofline_fraction"] <= 1


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen2-moe-a2.7b",
                                  "whisper-medium"])
@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["single", "multi"])
def test_train_cell_collectives_are_the_mesh_trainer_s(arch, multi_pod):
    """The messages of a ``Trainer(mesh=)`` step, reckoned here from the
    leaves' sizes (as ``tests/test_torch_train_mesh.py`` reckons the
    bytes ``comm.COUNTS`` gains): an all-gather over the world of every
    sharded leaf, [world, *block], and an all-reduce over the batch line
    of every leaf but the parity (``/cdc``: the trainer's step runs with
    no mask, so its loss reads no parity leaf) and of the loss."""
    rec = _cell(arch, "train_smoke", multi_pod)
    mesh = make_test_mesh(2, 2, pod=2) if multi_pod else make_test_mesh(2, 4)
    cfg = smoke_config(get_arch(arch))
    model = build(cfg, TPCtx(tp=mesh.shape["model"], mode="coded",
                             code_r=2))
    with torch.no_grad():
        params = model.encode_offline(
            model.init(0, dryrun.DTYPE, device="meta"))
    world, line = mesh.size, math.prod(mesh.shape[a]
                                       for a in batch_axes(mesh))
    gathers = reduces = 0
    gathered = reduced = 0.0
    n_cdc = 0
    for (name, _), (leaf, spec) in zip(
            named_leaves(params),
            paired_leaves(params, param_specs(params, mesh))):
        nb = leaf.numel() * leaf.element_size()
        if any(a is not None for a in spec):
            parts = math.prod(p for _, p in block_index(spec, mesh, 0))
            gathers += 1
            gathered += world * (nb // parts) * (world - 1) / world
        if name.endswith("/cdc"):
            n_cdc += 1
            continue
        reduces += 1
        reduced += 2 * nb * (line - 1) / line
    assert n_cdc > 0
    reduces += 1
    reduced += 2 * 4 * (line - 1) / line          # the float32 loss
    assert rec["collective_counts"] == {
        "all-gather": gathers, "all-reduce": reduces, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0}
    coll = rec["collectives"]
    assert coll["all-gather"] == pytest.approx(gathered, rel=1e-12)
    assert coll["all-reduce"] == pytest.approx(reduced, rel=1e-12)
    assert coll["total"] == pytest.approx(gathered + reduced, rel=1e-12)


def test_counts_of_is_what_comm_counts_for_the_messages():
    """An all-gather sends its 1/n of the result and receives the rest, an
    all-reduce sends and receives its tensor; staged (a card on gloo), each
    message's input and result go through host buffers."""
    msgs = [("all-gather", 400, 4), ("all-reduce", 36, 2),
            ("all-reduce", 4, 2)]
    assert comm.counts_of(msgs) == {"calls": 3, "sent": 100 + 36 + 4,
                                    "received": 300 + 36 + 4, "staged": 0}
    assert comm.counts_of(msgs, staged=True)["staged"] == \
        (100 + 400) + (36 + 36) + (4 + 4)
    with pytest.raises(ValueError, match="no COUNTS reckoning"):
        comm.counts_of([("all-to-all", 8, 2)])


def test_train_cost_is_the_microbatches_and_the_update(monkeypatch):
    """A train cell's cost is its counted microbatch times ``microbatches``
    plus the update. Dot FLOPs grow with the rows: mb microbatches of 1/mb
    of the rank's batch count the FLOPs of one microbatch of all of it; the
    update adds bytes (the norm, AdamW's passes over rank 0's blocks) and
    no dot FLOPs."""
    cell = ("granite-3-8b", "train_smoke")
    rec = _cell(*cell, False)
    mb = rec["microbatches"]
    assert mb > 1

    class Nothing:
        flops = bytes = custom_calls_uncosted = 0

    monkeypatch.setattr(dryrun, "_update_cost", lambda *a: Nothing())
    steps = {}
    for n in (1, mb):
        monkeypatch.setattr(dryrun, "microbatches_for", lambda *a, n=n: n)
        steps[n] = dryrun.lower_cell(*cell, multi_pod=False, coded=True,
                                     smoke=True, verbose=False)["cost"]
    assert steps[mb]["flops"] == steps[1]["flops"] == rec["cost"]["flops"]
    assert steps[mb]["bytes"] > steps[1]["bytes"]   # weights read mb times
    assert rec["cost"]["bytes"] > steps[mb]["bytes"]


def test_a_cell_counts_the_same_whichever_runs_first():
    """The enc-dec's decode step caches its position table once a process:
    the dry run warms the step before counting, so the count is a step's."""
    encdec._pos_table.cache_clear()
    first = dryrun.lower_cell("whisper-medium", "decode_smoke",
                              multi_pod=False, coded=True, smoke=True,
                              verbose=False)
    again = dryrun.lower_cell("whisper-medium", "decode_smoke",
                              multi_pod=False, coded=True, smoke=True,
                              verbose=False)
    assert first["cost"] == again["cost"]
