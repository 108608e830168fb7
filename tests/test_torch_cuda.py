"""The port's CUDA kernels on the card, against their plain versions.

These need a CUDA device (and nvcc, to build the kernels): without one
they skip. On the card:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.cuda


@pytest.fixture
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode (their "
                    "plain versions are tested in test_torch_kernels_plain)")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.device import set_true_f32
    set_true_f32()
    return chip_smoke


def test_coded_matmul_kernel_matches_plain(smoke):
    assert smoke.check_coded_matmul() <= 1e-4


def test_fused_head_kernel_matches_plain(smoke):
    from repro_torch.configs import get_arch
    assert smoke.check_fused_head(get_arch("granite-3-8b")) <= 1e-4


def test_fused_head_plan_edges_match_plain(smoke):
    assert smoke.check_head_edges() == 0.0


def test_rmsnorm_plan_edges_match_plain(smoke):
    assert smoke.check_rmsnorm_edges() <= 1e-5


def test_encode_kernel_matches_plain(smoke):
    from repro_torch.configs import get_arch
    assert smoke.check_encode(get_arch("granite-3-8b")) <= 1e-5


def test_coded_matmul_kernel_at_r3_r4_matches_plain(smoke):
    assert smoke.check_coded_matmul_r34() <= 1e-4


def test_coded_matmul_kernel_at_t8_r3_r4_matches_plain(smoke):
    assert smoke.check_coded_matmul_t8() <= 1e-4


def test_decode_merge_kernel_matches_plain(smoke):
    assert smoke.check_decode_merge() <= 1e-5


def test_decode_kernel_matches_plain(smoke):
    assert smoke.check_decode() <= 1e-5


def test_rmsnorm_kernel_matches_plain(smoke):
    assert smoke.check_rmsnorm() <= 1e-5


def test_stream_plan_edges_match_plain(smoke):
    assert max(smoke.check_stream_edges()) <= 1e-4


def test_matmul_kernel_matches_plain(smoke):
    assert smoke.check_matmul() <= 1e-4


def test_coded_matmul_kernel_at_t16_matches_plain(smoke):
    assert smoke.check_coded_matmul_t16() <= 1e-4


def test_coded_matmul_kernel_on_bf16_matches_plain(smoke):
    assert smoke.check_coded_matmul_bf16() <= 2e-2


def test_fused_head_kernel_at_t16_and_bf16_matches_plain(smoke):
    from repro_torch.configs import get_arch
    assert smoke.check_fused_head_wide(get_arch("granite-3-8b")) <= 2e-2


def test_fused_head_plan_edges_on_bf16_match_plain(smoke):
    assert smoke.check_head_edges(torch.bfloat16) == 0.0


def test_encode_kernel_on_bf16_matches_plain(smoke):
    from repro_torch.configs import get_arch
    err, scale = smoke.check_encode_bf16(get_arch("granite-3-8b"))
    assert err <= 2e-2 + 2e-2 * scale


def test_replayed_round_equals_eager_round_bitwise(smoke):
    """At smoke size on the card: rounds replayed from captured CUDA graphs
    give the eager fused rounds' tokens, kernel-2 maxima and KV state to the
    bit, across a mask change (a second graph) and a re-encode (graphs
    dropped and captured again)."""
    import numpy as np
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import TPCtx, build
    from repro_torch.runtime.executor import SlotPoolExecutor
    from repro_torch.serve import ModelStepper
    cfg = smoke_config(get_arch("granite-3-8b"))
    model = build(cfg, TPCtx(tp=4, mode="coded", code_r=2))
    stepper = ModelStepper(model, model.init(0, device="cuda"), max_len=32)
    graph, eager = (SlotPoolExecutor(stepper, 3, overlap=False,
                                     use_fused=True, use_graphs=g)
                    for g in (True, False))
    full = np.ones(4, bool)
    dead = np.array([True, False, True, True])
    rng = np.random.default_rng(0)
    for slot in range(3):
        prompt = rng.integers(0, cfg.vocab, 5 + slot)
        assert graph.admit(slot, prompt, full) == \
            eager.admit(slot, prompt, full)
    for i, valid in enumerate([full, full, dead, dead, full, full, dead]):
        if i == 4:
            stepper.reencode()
        assert graph.step_round(valid) == eager.step_round(valid)
        for a, b in zip(graph.vstep.last_head, eager.vstep.last_head):
            assert torch.equal(a, b)
    for name, t in graph.state["kv"].items():
        assert torch.equal(t, eager.state["kv"][name]), name
    vs = graph.vstep
    assert (vs.n_captures, vs.n_replays, vs.n_graph_drops) == (4, 7, 1)
