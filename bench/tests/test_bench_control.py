"""The control on the card: the plain reference computed with TF32 on (the
precision just below the configurations' float32 with TF32 off) departs
from the float32 reference by far more than the port's own forward does
(at two layers), and, at each configuration's full depth over as many
tokens as its cell reads, put in the program's place and judged by the
cell's own limits, it comes out as not correct. The readings at the
cells' own load come from ``bench/control.py`` on the chip."""
import numpy as np
import pytest
import torch

from harness import cells, check, weights

CELLS = ["granite-3-8b.conv10", "qwen2-moe-a2.7b.sharegpt10"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(cfg):
    from repro_torch.models import TPCtx, build
    code = cfg["code"]
    return build(cells.port_arch(cfg), TPCtx(
        tp=code["T"], mode="coded", code_r=code["r"],
        code_layout=code["layout"], moe_capacity=0))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_departs_more_than_the_port(card, cell):
    cfg = dict(cells.config(cells.workload(cell)["config"]),
               num_hidden_layers=2)
    model = _model(cfg)
    params, _ = weights.make(model, 2 ** 34 + 1, card, cfg["vocab_size"])
    coded = model.encode_offline(params)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg["vocab_size"], 256), device=card)
    ref = cells.module("reference", cfg["reference"])
    exact = ref.forward(cfg, params, tokens)
    with torch.no_grad():
        port = model.forward(coded, {"tokens": tokens[None]})[0]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        low = ref.forward(cfg, params, tokens)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    port_err = (port - exact).abs().max().item()
    ctrl_err = (low - exact).abs().max().item()
    assert ctrl_err > 10 * port_err, (ctrl_err, port_err)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_breaks_the_cell_limit(card, cell):
    spec = cells.workload(cell)["check"]
    cfg = cells.config(cells.workload(cell)["config"])
    params, flat = weights.make(_model(cfg), 2 ** 34 + 7, card,
                                cfg["vocab_size"])
    toks = np.random.default_rng(1).integers(
        0, cfg["vocab_size"], 64 + spec["tokens"])
    reqs = [(toks[:64], toks[64:].tolist())]
    ref = cells.module("reference", cfg["reference"])
    got = check.readings(ref, cfg, params, reqs, card, control=True)
    assert got["tokens"] == spec["tokens"]
    judged = check.judge(spec, check.as_program(got))
    assert not check.passes(judged), judged
