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


def test_whisper_graph_round_equals_eager_round_bitwise(smoke):
    """whisper at smoke size on the card, each slot with its own frames:
    rounds replayed from captured CUDA graphs give the eager fused rounds'
    tokens, kernel-2 maxima, self-attention cache and (untouched)
    cross-attention bank to the bit, across a mask change."""
    import numpy as np
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import TPCtx, build
    from repro_torch.runtime.executor import SlotPoolExecutor
    from repro_torch.serve import ModelStepper
    cfg = smoke_config(get_arch("whisper-medium"))
    model = build(cfg, TPCtx(tp=4, mode="coded", code_r=2))
    stepper = ModelStepper(model, model.init(0, device="cuda"), max_len=32)
    graph, eager = (SlotPoolExecutor(stepper, 3, overlap=False,
                                     use_fused=True, use_graphs=g)
                    for g in (True, False))
    full = np.ones(4, bool)
    dead = np.array([True, True, False, True])
    rng = np.random.default_rng(0)
    for slot in range(3):
        prompt = rng.integers(0, cfg.vocab, 5 + slot)
        extras = {"frames": rng.normal(size=(cfg.enc_seq, cfg.d_model))}
        assert graph.admit(slot, prompt, full, extras=extras) == \
            eager.admit(slot, prompt, full, extras=extras)
    for valid in [full, full, dead, dead, full]:
        assert graph.step_round(valid) == eager.step_round(valid)
        for a, b in zip(graph.vstep.last_head, eager.vstep.last_head):
            assert torch.equal(a, b)
    for part in ("kv", "xkv"):
        for name, t in graph.state[part].items():
            assert torch.equal(t, eager.state[part][name]), (part, name)
    vs = graph.vstep
    assert (vs.n_captures, vs.n_replays) == (2, 5)


def test_xlstm_graph_round_equals_eager_round_bitwise(smoke):
    """xLSTM at smoke size on the card (dedicated r = 2): rounds replayed
    from captured CUDA graphs give the eager fused rounds' tokens,
    kernel-2 maxima and block states (slot axis 0, written in place) to
    the bit, across mask changes and a 2-dead round between replays
    (the eager reference variant on both pools)."""
    import numpy as np
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import TPCtx, build
    from repro_torch.runtime.executor import SlotPoolExecutor
    from repro_torch.serve import ModelStepper
    cfg = smoke_config(get_arch("xlstm-125m"))
    model = build(cfg, TPCtx(tp=4, mode="coded", code_r=2,
                             code_layout="dedicated"))
    stepper = ModelStepper(model, model.init(0, device="cuda"), max_len=32)
    graph, eager = (SlotPoolExecutor(stepper, 3, overlap=False,
                                     use_fused=True, use_graphs=g)
                    for g in (True, False))
    full = np.ones(4, bool)
    dead = np.array([True, False, True, True])
    two = np.array([True, False, False, True])
    rng = np.random.default_rng(0)
    for slot in range(3):
        prompt = rng.integers(0, cfg.vocab, 5 + slot)
        assert graph.admit(slot, prompt, full) == \
            eager.admit(slot, prompt, full)
    for valid in [full, full, dead, two, dead, full]:
        assert graph.step_round(valid) == eager.step_round(valid)
        if graph.vstep.last_variant == "fused":
            for a, b in zip(graph.vstep.last_head, eager.vstep.last_head):
                assert torch.equal(a, b)
    for i, (gb, eb) in enumerate(zip(graph.state["blocks"],
                                     eager.state["blocks"])):
        for name, t in gb.items():
            assert torch.equal(t, eb[name]), (i, name)
    vs = graph.vstep
    assert (vs.n_captures, vs.n_replays) == (2, 5)


def test_hybrid_graph_round_equals_eager_round_bitwise(smoke):
    """hymba at smoke size on the card (dedicated r = 2): rounds replayed
    from captured CUDA graphs give the eager fused rounds' tokens,
    kernel-2 maxima and decode states (the KV cache and the mamba conv
    window and SSM state, slot axis 1, written in place) to the bit,
    across mask changes and a 2-dead round between replays (the eager
    reference variant on both pools)."""
    import numpy as np
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import TPCtx, build
    from repro_torch.runtime.executor import SlotPoolExecutor
    from repro_torch.serve import ModelStepper
    cfg = smoke_config(get_arch("hymba-1.5b"))
    model = build(cfg, TPCtx(tp=4, mode="coded", code_r=2,
                             code_layout="dedicated"))
    stepper = ModelStepper(model, model.init(0, device="cuda"), max_len=80)
    graph, eager = (SlotPoolExecutor(stepper, 3, overlap=False,
                                     use_fused=True, use_graphs=g)
                    for g in (True, False))
    ptrs = [t.data_ptr() for t in smoke._state_leaves(graph.state)]
    full = np.ones(4, bool)
    dead = np.array([True, False, True, True])
    two = np.array([True, False, False, True])
    rng = np.random.default_rng(0)
    for slot in range(3):
        prompt = rng.integers(0, cfg.vocab, 60 + slot)
        assert graph.admit(slot, prompt, full) == \
            eager.admit(slot, prompt, full)
    for valid in [full, full, dead, two, dead, full]:
        assert graph.step_round(valid) == eager.step_round(valid)
        if graph.vstep.last_variant == "fused":
            for a, b in zip(graph.vstep.last_head, eager.vstep.last_head):
                assert torch.equal(a, b)
    for a, b in zip(smoke._state_leaves(graph.state),
                    smoke._state_leaves(eager.state)):
        assert torch.equal(a, b)
    assert [t.data_ptr() for t in smoke._state_leaves(graph.state)] == ptrs
    vs = graph.vstep
    assert (vs.n_captures, vs.n_replays) == (2, 5)


# ------------------------------------------------ every code width T <= 16

def test_coded_matmul_generic_instantiation_matches_plain(smoke):
    assert smoke.check_coded_matmul_any() <= 1e-4
    assert smoke.check_coded_matmul_any(torch.bfloat16) <= 2e-2


def test_fused_head_generic_instantiation_matches_plain(smoke):
    from repro_torch.configs import get_arch
    cfg = get_arch("granite-3-8b")
    assert smoke.check_head_any(cfg) <= 1e-4
    assert smoke.check_head_any(cfg, torch.bfloat16) == 0.0


def test_elementwise_generic_instantiations_match_plain(smoke):
    err3, err5 = smoke.check_elementwise_any()
    err4, err4_bf16 = smoke.check_encode_any()
    assert max(err3, err4, err5) <= 1e-5 and err4_bf16 <= 2e-2


def test_rowcopy_instantiation_matches_plain_at_t12_w1(smoke):
    """Kernel 1 at T = 12 w1's 89-column slices (reduced k), fault-free,
    one data shard dead, one parity slot dead and two dead: within 1e-4 of
    the plain version, equal to the bit on integer inputs, repeats
    bitwise equal (chip_smoke.check_rowcopy raises otherwise)."""
    t12 = [c for c in smoke.ROWCOPY_SHAPES if c[1] == 12
           and c[5] == torch.float32 and c[4] == "folded"]
    err, _ = smoke.check_rowcopy(k=1024, shapes=t12)
    assert err <= 1e-4


def test_rowcopy_instantiation_on_bf16_at_t16_matches_plain(smoke):
    bf = [c for c in smoke.ROWCOPY_SHAPES if c[5] == torch.bfloat16]
    _, err = smoke.check_rowcopy(k=1024, shapes=bf)
    assert err <= 2e-2


def test_rowcopy_instantiation_at_every_shape_matches_plain(smoke):
    err, err_bf16 = smoke.check_rowcopy()
    assert err <= 1e-4 and err_bf16 <= 2e-2


def test_encode_at_t12_is_bitwise_repeatable_and_matches_plain(smoke):
    """Kernel 4's generic instantiation at T = 12 (w1's 89-column slices
    on 16-byte reads, wq): parity bitwise equal on repeats and within
    1e-5 of the plain version (chip_smoke.check_encode_any)."""
    err, err_bf16 = smoke.check_encode_any()
    assert err <= 1e-5 and err_bf16 <= 2e-2


def test_padded_heads_serve_at_t12_on_the_card(smoke):
    """granite at smoke size, T = 12 (heads padded 4 -> 12): fused graph
    rounds, with a shard erased mid-stream, give the reference variant's
    tokens."""
    import numpy as np
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import TPCtx, build
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = smoke_config(get_arch("granite-3-8b"))
    model = build(cfg, TPCtx(tp=12, mode="coded", code_r=2))
    params = model.init(0, device="cuda")
    batch = {"tokens": np.random.default_rng(0).integers(0, cfg.vocab,
                                                         (3, 7))}
    scfg = ServeConfig(max_len=24, batch=3)
    fused = ServingEngine(model, params, scfg, use_fused=True).generate(
        batch, 8, fail_at={3: 5})
    ref = ServingEngine(model, params, scfg, use_fused=False).generate(
        batch, 8, fail_at={3: 5})
    np.testing.assert_array_equal(fused, ref)


# ------------------------------------------------------ the MoE family ----

def test_moe_kernels_at_both_configs_widths_match_plain(smoke):
    """Phase 16's kernel checks: kernels 1, 2 and 4 at qwen2-moe's and
    qwen3-moe's widths (``moe_shapes``: k 2048 and 4096; the heads' 151936
    words at m_l 37984 with a planted tie; every parity leaf) against
    their plain versions (``check_width_kernels`` raises otherwise)."""
    for tag, (cfg, gemms) in smoke._moe_cfgs().items():
        err1, err2, err4 = smoke.check_width_kernels(
            tag, smoke.moe_shapes(cfg, gemms))
        assert err1 <= 1e-4 and err2 <= 1e-4 and err4 <= 1e-5, tag


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_moe_graph_round_equals_eager_round_bitwise(smoke, name):
    """An MoE at smoke size on the card (capacity 0; qwen3's query 64 wide
    a head over d = 128): rounds replayed from captured CUDA graphs give
    the eager fused rounds' tokens, kernel-2 maxima and KV cache to the
    bit, across a mask change: the routing's sorts, the dispatch and the
    fixed-order combine run on the device with no host sync and no
    atomics."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import TPCtx, build
    from repro_torch.runtime.executor import SlotPoolExecutor
    from repro_torch.serve import ModelStepper
    cfg = smoke_config(get_arch(name))
    if cfg.n_kv_heads < cfg.n_heads:
        cfg = dataclasses.replace(cfg, head_dim=64)
    model = build(cfg, TPCtx(tp=4, mode="coded", code_r=2, moe_capacity=0))
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
    for valid in [full, full, dead, dead, full]:
        assert graph.step_round(valid) == eager.step_round(valid)
        for a, b in zip(graph.vstep.last_head, eager.vstep.last_head):
            assert torch.equal(a, b)
    for key, t in graph.state["kv"].items():
        assert torch.equal(t, eager.state["kv"][key]), key
    vs = graph.vstep
    assert (vs.n_captures, vs.n_replays) == (2, 5)


def test_rmsnorm_bwd_kernel_matches_plain(smoke):
    """Kernel 6's backward against its plain version (dx within 1e-5,
    dgamma within 1e-4 of its largest entry, repeats bitwise equal, every
    instantiation launched, bf16 refused) and the autograd Function."""
    err = smoke.check_rmsnorm_bwd()
    assert err["dx"] <= 1e-5 and err["dgamma_rel"] <= 1e-4


def test_kernels_without_a_backward_refuse_requires_grad(smoke):
    assert smoke.check_grad_refusals() == sorted(
        ["cdc_coded_matmul", "cdc_fused_head_argmax", "cdc_encode",
         "cdc_decode_merge", "cdc_decode", "matmul"])


def test_granite_smoke_train_step_on_card_matches_cpu(smoke):
    """One train step of coded smoke granite (T = 4, r = 2 folded, remat
    "full") on the card, with kernel 6 and its backward on every norm,
    against the same step on the CPU (plain versions): every gradient leaf
    of ``value_and_grad`` within 1e-4 (AdamW's first update is close to
    lr * sign(g), so the params alone would not show a gradient wrong by a
    scale), the loss and global norm within 1e-5, every param within 1e-4
    after the step (where a gradient is near eps the two devices' rounding
    shows in the update)."""
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.data import DataConfig, make_stream
    from repro_torch.kernels import rmsnorm
    from repro_torch.models import TPCtx, build
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train import TrainConfig, make_train_step, train_step
    from repro_torch.tree import named_leaves, tree_map
    cfg = smoke_config(get_arch("granite-3-8b"))
    model = build(cfg, TPCtx(tp=4, mode="coded", code_r=2))
    with torch.no_grad():
        cpu = model.encode_offline(model.init(0, device="cpu"))
    card = tree_map(lambda t: t.to("cuda"), cpu)
    batch = next(make_stream(DataConfig(cfg.vocab, 32, 4)))
    tcfg = TrainConfig(remat="full")
    loss_fn = train_step.make_loss_fn(model, tcfg)
    _, g_card = train_step.value_and_grad(loss_fn, card, batch)
    _, g_cpu = train_step.value_and_grad(loss_fn, cpu, batch)
    want = dict(named_leaves(g_cpu))
    for name, g in named_leaves(g_card):
        if g is None or want[name] is None:
            assert g is None and want[name] is None, name
            continue
        torch.testing.assert_close(g.cpu(), want[name], rtol=1e-4,
                                   atol=1e-4, msg=lambda m: f"{name}: {m}")
    step = make_train_step(model, AdamWConfig(lr=3e-3, warmup_steps=2),
                           tcfg)
    n6, n6b = rmsnorm.rmsnorm.launches, rmsnorm.rmsnorm_bwd.launches
    card, _, mc = step(card, init_state(card), batch)
    cpu, _, mp = step(cpu, init_state(cpu), batch)
    L = cfg.n_layers
    assert rmsnorm.rmsnorm.launches - n6 == 4 * L + 1
    assert rmsnorm.rmsnorm_bwd.launches - n6b == 2 * L + 1
    for k in ("loss", "grad_norm"):
        assert float(mc[k]) == pytest.approx(float(mp[k]), rel=1e-5), k
    want = dict(named_leaves(cpu))
    for name, t in named_leaves(card):
        torch.testing.assert_close(t.cpu(), want[name], rtol=1e-4,
                                   atol=1e-4, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "hymba-1.5b"])
def test_family_smoke_train_step_on_card_matches_cpu(smoke, name):
    """``value_and_grad`` of coded smoke qwen2-moe (capacity 1.25: pairs
    dropped) and hymba (the mamba scan under autograd), remat "full", on
    the card (kernel 6 and its backward on every norm) against the CPU
    (plain versions): the loss within 1e-5, every gradient leaf within
    1e-4; then one train step's loss and grad norm within 1e-5."""
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.data import DataConfig, make_stream
    from repro_torch.kernels import rmsnorm
    from repro_torch.models import TPCtx, build
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train import TrainConfig, make_train_step, train_step
    from repro_torch.tree import named_leaves, tree_map
    cfg = smoke_config(get_arch(name))
    model = build(cfg, TPCtx(tp=4, mode="coded", code_r=2,
                             moe_capacity=1.25))
    with torch.no_grad():
        cpu = model.encode_offline(model.init(0, device="cpu"))
    card = tree_map(lambda t: t.to("cuda"), cpu)
    batch = next(make_stream(DataConfig(cfg.vocab, 32, 4)))
    tcfg = TrainConfig(remat="full")
    loss_fn = train_step.make_loss_fn(model, tcfg)
    n6b = rmsnorm.rmsnorm_bwd.launches
    l_card, g_card = train_step.value_and_grad(loss_fn, card, batch)
    assert rmsnorm.rmsnorm_bwd.launches - n6b == 2 * cfg.n_layers + 1
    l_cpu, g_cpu = train_step.value_and_grad(loss_fn, cpu, batch)
    assert float(l_card) == pytest.approx(float(l_cpu), rel=1e-5)
    want = dict(named_leaves(g_cpu))
    for leaf, g in named_leaves(g_card):
        if g is None or want[leaf] is None:
            assert g is None and want[leaf] is None, leaf
            continue
        torch.testing.assert_close(g.cpu(), want[leaf], rtol=1e-4,
                                   atol=1e-4, msg=lambda m: f"{leaf}: {m}")
    step = make_train_step(model, AdamWConfig(lr=3e-3, warmup_steps=2),
                           tcfg)
    _, _, mc = step(card, init_state(card), batch)
    _, _, mp = step(cpu, init_state(cpu), batch)
    for k in ("loss", "grad_norm"):
        assert float(mc[k]) == pytest.approx(float(mp[k]), rel=1e-5), k


def _dist_w1_rank(rank, n):
    """A rank of the 4-rank world below: chip_smoke's phase 18 (a) at
    granite's w1 only (4 and 64 rows, both layouts, every mask)."""
    import chip_smoke
    from repro_torch.device import set_true_f32
    from repro_torch.dist import Mesh
    set_true_f32()
    return chip_smoke.dist_gemm_cases(rank, Mesh((n,), ("model",)), n,
                                      ("w1",), ("folded", "dedicated"))


def test_coded_gemm_across_four_ranks_on_the_card(smoke):
    """Phase 18 (a)'s T = 4 w1 case in a 4-rank world on the card (gloo,
    host-staged): every rank's block within 1e-4 of the single-process
    coded GEMM (kernel 1) and 2e-3 of x @ w, finite although the dead rank
    sent NaN, and kernel 3 launched once a call under <= 1 dead (the rank
    program raises otherwise)."""
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    from repro_torch.dist import spawn_world
    from repro_torch.kernels import build
    build.build_all()
    out = spawn_world(_dist_w1_rank, 4, timeout_s=300)
    assert all(r["max_abs_err"] <= 1e-4 for r in out)
    assert all(r["k3"] > 0 for r in out)
