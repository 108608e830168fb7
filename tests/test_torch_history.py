"""The port's ``obs.history`` against the reference's ``repro.obs.history``.

Both packages write and read one JSONL schema: records written by either
load in the other (an unparsable line, a non-record line and a record of a
newer schema skipped), and the same baselines and candidates give equal
regressions, synthetic slowdowns, gate results and CLI exit codes, for
throughput-like (higher), latency-like (lower) and deterministic (match)
metrics, within and beyond their tolerances.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.obs import history as jh
from repro_torch.obs import history as th

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = [(jh, th), (th, jh)]
IDS = ["reference-writes", "port-writes"]

# metric -> (baseline values, candidate within tolerance, beyond it)
CASES = {
    "rounds_per_s": ([100.0, 104.0, 98.0, 101.0, 99.0], 80.0, 70.0),
    "ttft_p99_ms": ([10.0, 12.0, 11.0, 9.0, 10.5], 15.0, 16.0),
    "model_flops": ([1e9, 1e9, 1e9, 1e9, 1e9], 1.005e9, 0.98e9),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_schema_and_default_tolerances_are_the_reference_s():
    assert th.SCHEMA_VERSION == jh.SCHEMA_VERSION
    assert th.DEFAULT_TOLERANCES == jh.DEFAULT_TOLERANCES


def test_make_snapshot_is_the_reference_s():
    kw = dict(sha="abc1234", ts=12.5, extra={"note": "x"})
    metrics = {"rounds_per_s": 3, "ttft_p99_ms": 2.5, "label": "dropped",
               "none": None}
    assert th.make_snapshot("b", "a", metrics, **kw) == \
        jh.make_snapshot("b", "a", metrics, **kw)


@pytest.mark.parametrize("writer,reader", PACKAGES, ids=IDS)
def test_each_package_reads_the_other_s_history(tmp_path, writer, reader):
    """Records appended by one package load in the other, in order; an
    unparsable line, a line with no record, a blank line and a schema-99
    record are skipped by both."""
    path = str(tmp_path / "sub" / "h.jsonl")
    want = [writer.append_snapshot(path, "serve", "granite-3-8b",
                                   {"rounds_per_s": 10.0 + i,
                                    "ttft_p99_ms": 5.0 - i},
                                   sha=f"s{i}", ts=1.0 + i)
            for i in range(2)]
    with open(path, "a") as f:
        f.write("{not json\n\n")
        f.write(json.dumps([1, 2]) + "\n")
        f.write(json.dumps({"schema": 99, "ts": 0, "bench": "serve",
                            "arch": "granite-3-8b",
                            "metrics": {"rounds_per_s": 1.0}}) + "\n")
    want.append(writer.append_snapshot(path, "train", "xlstm-125m",
                                       {"tokens_per_s": 7.0}, sha="s2",
                                       ts=3.0))
    assert reader.load_history(path) == want
    assert writer.load_history(path) == want
    assert reader.load_history(str(tmp_path / "missing.jsonl")) == []


def _records(metric: str, values, cand=None) -> list[dict]:
    recs = [jh.make_snapshot("bench", "arch", {metric: v}, sha=f"s{i}",
                             ts=float(i)) for i, v in enumerate(values)]
    if cand is not None:
        recs.append(jh.make_snapshot("bench", "arch", {metric: cand},
                                     sha="cand", ts=99.0))
    return recs


@pytest.mark.parametrize("metric", sorted(CASES))
@pytest.mark.parametrize("beyond", [False, True],
                         ids=["within", "beyond"])
def test_compare_is_the_reference_s(metric, beyond):
    base, within, past = CASES[metric]
    cand = _records(metric, [past if beyond else within])[0]
    baseline = _records(metric, base)
    got = th.compare(cand, baseline)
    assert got == jh.compare(cand, baseline)
    assert [r["metric"] for r in got] == ([metric] if beyond else [])
    # a tolerance override and a short window
    over = {metric: 0.01}
    assert th.compare(cand, baseline, over, last_n=2) == \
        jh.compare(cand, baseline, over, last_n=2)


@pytest.mark.parametrize("metric", sorted(CASES))
@pytest.mark.parametrize("frac", [0.1, 0.3])
def test_synthetic_slowdown_is_the_reference_s(metric, frac):
    baseline = _records(metric, CASES[metric][0])
    got = th.synthetic_slowdown(baseline, frac)
    want = jh.synthetic_slowdown(baseline, frac)
    assert {k: v for k, v in got.items() if k != "ts"} == \
        {k: v for k, v in want.items() if k != "ts"}


def _history(tmp_path, metric: str, beyond: bool) -> str:
    """Two groups: ``metric``'s five baselines and a candidate within or
    beyond its tolerance, and a one-record group."""
    base, within, past = CASES[metric]
    path = str(tmp_path / "h.jsonl")
    for rec in _records(metric, base, past if beyond else within):
        jh.append_snapshot(path, rec["bench"], rec["arch"], rec["metrics"],
                           sha=rec["git_sha"], ts=rec["ts"])
    th.append_snapshot(path, "other", "alone", {metric: base[0]}, sha="x",
                       ts=0.0)
    return path


@pytest.mark.parametrize("metric", sorted(CASES))
@pytest.mark.parametrize("beyond", [False, True], ids=["within", "beyond"])
@pytest.mark.parametrize("inject", [0.0, 0.3])
def test_check_history_is_the_reference_s(tmp_path, metric, beyond, inject):
    path = _history(tmp_path, metric, beyond)
    for kw in ({}, {"bench": "bench"}, {"arch": "alone"},
               {"last_n": 3, "tolerances": {metric: 0.2}}):
        got = th.check_history(path, inject_slowdown=inject, **kw)
        assert got == jh.check_history(path, inject_slowdown=inject, **kw)
    got = th.check_history(path, inject_slowdown=inject)
    fired = any(r["regressions"] for r in got)
    if inject:
        # 0.3 is beyond the throughput tolerance (0.25) only
        assert fired == (metric == "rounds_per_s")
    else:
        assert fired == beyond


@pytest.mark.parametrize("argv,code", [
    ([], 0), (["--inject-slowdown", "0.30"], 1), (["--bench", "none"], 0),
    (["--tolerance", "rounds_per_s=0.5", "--inject-slowdown", "0.30"], 0)],
    ids=["plain", "slowdown", "no-records", "loosened"])
def test_cli_exit_codes_and_lines_are_the_reference_s(tmp_path, capsys,
                                                      argv, code):
    path = _history(tmp_path, "rounds_per_s", False)
    args = ["check", "--path", path] + argv
    assert jh.main(args) == code
    want = capsys.readouterr().out
    assert th.main(args) == code
    assert capsys.readouterr().out == want


def test_cli_runs_as_a_module(tmp_path):
    """``python -m repro_torch.obs.history append`` then ``check``: exit 0,
    and 1 with ``--inject-slowdown 0.30``; the appended line loads in the
    reference."""
    path = str(tmp_path / "h.jsonl")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.history", *args],
            capture_output=True, text=True, env=env, cwd=tmp_path,
            timeout=120)

    out = cli("append", "--path", path, "--bench", "examples", "--arch",
              "quickstart", "--metric", "rounds_per_s=2.5")
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout)
    assert jh.load_history(path) == [rec]
    assert rec["metrics"] == {"rounds_per_s": 2.5}
    assert cli("check", "--path", path).returncode == 0
    slow = cli("check", "--path", path, "--inject-slowdown", "0.30")
    assert slow.returncode == 1
    assert "REGRESSION examples/quickstart" in slow.stdout
