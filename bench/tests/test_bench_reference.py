"""The plain reference against the port's own CPU path at smoke size:
the port's teacher-forced forward through its coded GEMMs, with every
shard up and with one shard lost (the budget of r = 2 folded), on the weights the benchmark
makes."""
import numpy as np
import pytest
import torch

import bench_smoke
from harness import cells, weights

CONFIGS = ["granite-3-8b.t4r2.f32", "qwen2-moe-a2.7b.t4r2.f32"]


def _port(cfg):
    from repro_torch.models import TPCtx, build
    code = cfg["code"]
    ctx = TPCtx(tp=code["T"], mode="coded", code_r=code["r"],
                code_layout=code["layout"], moe_capacity=0)
    return build(cells.port_arch(cfg), ctx)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("dead", [(), (1,), (3,)])
def test_reference_matches_the_port(name, dead):
    cfg = bench_smoke.config(name)
    model = _port(cfg)
    params, _ = weights.make(model, 2 ** 33 + 5, torch.device("cpu"),
                             cfg["vocab_size"])
    coded = model.encode_offline(params)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg["vocab_size"], 24))
    valid = torch.ones(cfg["code"]["T"], dtype=torch.bool)
    valid[list(dead)] = False
    with torch.no_grad():
        port = model.forward(coded, {"tokens": tokens[None]}, valid)[0]
    ref = cells.module("reference", "plain").forward(cfg, params, tokens)
    assert ref.shape == (24, cfg["vocab_size"])
    assert torch.allclose(port, ref, rtol=1e-4, atol=1e-4), \
        (port - ref).abs().max()


def test_weights_are_seeded_views_of_one_buffer():
    cfg = bench_smoke.config(CONFIGS[1])
    model = _port(cfg)
    a, flat = weights.make(model, 7, torch.device("cpu"), cfg["vocab_size"])
    b, _ = weights.make(model, 7, torch.device("cpu"), cfg["vocab_size"])
    c, _ = weights.make(model, 8, torch.device("cpu"), cfg["vocab_size"])
    wq = a["layers"]["attn"]["wq"]["w"]
    assert wq.untyped_storage().data_ptr() == flat.untyped_storage() \
        .data_ptr()
    assert torch.equal(wq, b["layers"]["attn"]["wq"]["w"])
    assert not torch.equal(wq, c["layers"]["attn"]["wq"]["w"])
    assert a["layers"]["attn"]["wq"]["cdc"] is None
    head = a["lm_head"]["w"]
    assert torch.all(head[:, cfg["vocab_size"]:] == 0)


def test_port_refuses_an_equation_it_lacks():
    cfg = dict(cells.config(CONFIGS[0]), tie_word_embeddings=True)
    with pytest.raises(ValueError):
        cells.port_arch(cfg)
    cfg = dict(cells.config(CONFIGS[1]), norm_topk_prob=False)
    with pytest.raises(ValueError):
        cells.port_arch(cfg)
