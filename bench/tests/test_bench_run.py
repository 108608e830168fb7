"""A whole run of the harness on the CPU at smoke size, past its look for
a chip: correct on the program as it is, and not correct with the timed
path broken underneath (a token altered where it is produced; a decode
that leaves its state unchanged). Without a CUDA card the entry exits
non-zero and prints no result; nothing under bench/ imports JAX or the
JAX package, compared by whole top-level names."""
import ast
import json
import os
import subprocess
import sys

import pytest
import torch

import bench_smoke
from harness import cells
from harness.run import Run, forbidden_modules

SEED = 2 ** 32 + 321


def _run(cell_name):
    cell, cfg, mix = bench_smoke.cell(cell_name)
    run = Run(cell, SEED, 1.5, False, device="cpu", cfg=cfg, mix=mix)
    run.setup()
    run.serve()
    run.after_window()
    run.check()
    return run


def _token_altered(monkeypatch):
    from repro_torch.runtime.executor import vstep
    fn = vstep.VStep._round

    def round_(self, state, toks, valid):
        new_state, nxt, last = fn(self, state, toks, valid)
        return new_state, (nxt + 1) % last.shape[-1], last
    monkeypatch.setattr(vstep.VStep, "_round", round_)


def _state_unchanged(monkeypatch):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "_cache_update_per_row",
                        lambda cache, k, v, positions, s, C:
                        (cache["k"], cache["v"], cache["pos"]))


@pytest.mark.parametrize("cell_name", ["granite-3-8b.conv10",
                                       "qwen2-moe-a2.7b.sharegpt10"])
def test_run_is_correct(cell_name):
    run = _run(cell_name)
    assert run.correct, run.checks
    res = run.result()
    assert list(res)[-1] == "checks"
    for name in run.cell["end_to_end"]:
        assert res["metrics"][name]["value"] > 0
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    run = _run("granite-3-8b.conv10")
    assert not run.correct, run.checks


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(cells.BENCH / "run.py"), "--workload",
         "granite-3-8b.conv10", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        timeout=120, cwd=cells.ROOT)
    if torch.cuda.is_available():
        pytest.skip("a card is visible to this process")
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert "repro_torch_x" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in forbidden_modules()


def test_no_source_under_bench_imports_jax_or_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "repro"}
    for path in cells.BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and not node.level:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in bad, (path, n)
        assert "benchmarks/" not in path.read_text() \
            or path.name.startswith("test_"), path


def test_cells_report_what_benchmark_json_says():
    bench = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        assert w["chips"] == 1
        assert cells.workload(w["name"])["name"] == w["name"]
