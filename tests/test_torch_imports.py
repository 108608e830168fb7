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
    + [ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_dist.py",
       ROOT / "tests" / "_torch_train_mesh.py",
       ROOT / "tests" / "test_torch_timing_cuda.py",
       ROOT / "tests" / "test_torch_prefill_decode.py",
       ROOT / "tests" / "test_torch_prefill_decode_cuda.py",
       ROOT / "tests" / "test_torch_nemotron_h_cuda.py"]


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


def test_guard_covers_the_encoder_decoder():
    """The encoder-decoder's, xLSTM's, the hybrid's, training's, the
    distribution layer's and the dry run's modules (and the rank programs
    that spawned ranks import) are among the files the guard reads."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/models/encdec.py",
            "src/repro_torch/configs/whisper_medium.py",
            "src/repro_torch/models/xlstm.py",
            "src/repro_torch/configs/xlstm_125m.py",
            "src/repro_torch/models/mamba.py",
            "src/repro_torch/configs/hymba_1_5b.py",
            "src/repro_torch/train/trainer.py",
            "src/repro_torch/ckpt/checkpoint.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/dist/__init__.py",
            "src/repro_torch/dist/sharding.py",
            "src/repro_torch/dist/comm.py",
            "src/repro_torch/dist/collectives.py",
            "src/repro_torch/dist/pipeline.py",
            "src/repro_torch/dist/world.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/dryrun.py",
            "tests/_torch_dist.py",
            "tests/_torch_train_mesh.py"} <= names


def test_guard_covers_the_history_examples_and_roofline():
    """The benchmark history, the four examples and the dry run's cost and
    roofline modules are among the files the guard reads."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/obs/history.py",
            "src/repro_torch/examples/__init__.py",
            "src/repro_torch/examples/quickstart.py",
            "src/repro_torch/examples/serve_cdc.py",
            "src/repro_torch/examples/multi_failure.py",
            "src/repro_torch/examples/train_lm.py",
            "src/repro_torch/roofline/analysis.py",
            "src/repro_torch/launch/dryrun.py"} <= names


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


def test_train_without_device_flag_refuses_cpu(monkeypatch, tmp_path):
    """The training entry point and the Trainer run on the card unless
    told otherwise, as the serving entry point does."""
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.launch import train
    from repro_torch.models import TPCtx, build
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig, TrainConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--coded", "--steps", "2", "--no-resume",
                    "--ckpt-dir", str(tmp_path)])
    cfg = smoke_config(get_arch("granite-3-8b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(build(cfg, TPCtx(tp=4, mode="coded")),
                TrainerConfig(ckpt_dir=str(tmp_path)), AdamWConfig(),
                TrainConfig(), DataConfig(cfg.vocab, 8, 2))
    assert not list(tmp_path.iterdir())


def test_model_init_defaults_to_cuda(monkeypatch):
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import TPCtx, build
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build(smoke_config(get_arch("granite-3-8b")), TPCtx(tp=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    assert model.init(0, device="cpu")["embed"].device.type == "cpu"


def test_whisper_entry_points_default_to_cuda(monkeypatch):
    """whisper-medium's init and serving entry point run on the card unless
    told otherwise, as the decoders' do."""
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import TPCtx, build
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build(smoke_config(get_arch("whisper-medium")), TPCtx(tp=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "whisper-medium", "--smoke", "--coded"])
    assert model.init(0, device="cpu")["enc_layers"]["attn"]["wq"][
        "w"].device.type == "cpu"


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
    # what a spawned rank of the tests loads
    mods += ["_torch_dist", "_torch_train_mesh"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join(
                             [str(ROOT / "src"), str(ROOT / "tests")])})
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 30


@pytest.mark.parametrize("module", [
    "repro_torch.serve", "repro_torch.obs", "repro_torch.runtime",
    "repro_torch.kernels.ops", "repro_torch.launch.serve",
    "repro_torch.models", "repro_torch.models.encdec",
    "repro_torch.configs.whisper_medium", "repro_torch.models.xlstm",
    "repro_torch.configs.xlstm_125m", "repro_torch.models.mamba",
    "repro_torch.configs.hymba_1_5b", "repro_torch.train",
    "repro_torch.launch.train", "repro_torch.dist", "repro_torch.launch.mesh",
    "repro_torch.dist.world", "repro_torch.launch.dryrun",
    "repro_torch.obs.history", "repro_torch.examples.quickstart",
    "repro_torch.examples.serve_cdc", "repro_torch.examples.multi_failure",
    "repro_torch.examples.train_lm"])
def test_package_imports_first_in_a_fresh_interpreter(module):
    """No import cycle bites whichever package a program imports first
    (``obs`` and ``runtime`` import each other's leaf modules)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", f"import {module}"],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
