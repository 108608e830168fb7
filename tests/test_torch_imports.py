"""Guards of the port's boundaries.

  * no module of src/repro_torch, and not chip_smoke.py, imports jax or
    the reference package ``repro``;
  * the entry points run on the CUDA device unless told otherwise: without
    a card they raise instead of falling back to the CPU;
  * every package imports cleanly when a fresh interpreter imports it
    first (no import cycle).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.append(node.module)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_catches_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\n"
                     "from repro.core import coding\n"
                     "import repro_torch.core\n")
    assert [n for n in _imports(probe) if _forbidden(n)] == \
        ["jax.numpy", "repro.core"]


def test_serve_without_device_flag_refuses_cpu(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--coded"])


def test_model_init_defaults_to_cuda(monkeypatch):
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import TPCtx, build
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build(smoke_config(get_arch("granite-3-8b")), TPCtx(tp=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    assert model.init(0, device="cpu")["embed"].device.type == "cpu"


def test_serve_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    toks = serve.main(["--smoke", "--coded", "--device", "cpu",
                       "--gen-tokens", "4", "--prompt-len", "5",
                       "--fail-step", "1", "--fail-shard", "2"])
    assert toks.shape == (2, 4)
    assert "erasures_recovered': 1" in capsys.readouterr().out


def test_loading_every_port_module_loads_neither_jax_nor_reference():
    """Import every module of the port in a fresh interpreter: neither jax
    nor the reference package may end up in sys.modules, whatever the
    import graph pulls in at run time."""
    import os
    import subprocess
    import sys
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 30


@pytest.mark.parametrize("module", [
    "repro_torch.serve", "repro_torch.obs", "repro_torch.runtime",
    "repro_torch.kernels.ops", "repro_torch.launch.serve",
    "repro_torch.models"])
def test_package_imports_first_in_a_fresh_interpreter(module):
    """No import cycle bites whichever package a program imports first
    (``obs`` and ``runtime`` import each other's leaf modules)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", f"import {module}"],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
