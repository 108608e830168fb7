"""The layer-pattern stack (a small Nemotron-H) on the card (``-m cuda``;
skipped without one). No JAX here: the port is held to
``bench/reference/nemotron_h.py``, the plain torch reference.

  PYTHONPATH=src python -m pytest -q -m cuda \
      tests/test_torch_nemotron_h_cuda.py
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.cuda
PATTERN = "M-M*-M"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused round's kernels and CUDA "
                    "graphs have no CPU mode (the CPU path is tested in "
                    "tests/test_torch_nemotron_h.py)")
    from repro_torch.device import set_true_f32
    set_true_f32()
    path = ROOT / "bench" / "reference" / "nemotron_h.py"
    spec = importlib.util.spec_from_file_location("nemotron_h_ref", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    return ref


def _stepper(max_len=96):
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import TPCtx, build
    from repro_torch.serve import ModelStepper
    cfg = dataclasses.replace(smoke_config(get_arch("nemotron-h-47b")),
                              pattern=PATTERN, n_layers=len(PATTERN))
    model = build(cfg, TPCtx(tp=4, mode="coded", code_r=2))
    raw = model.init(0, device="cuda")
    return ModelStepper(model, raw, max_len=max_len), raw


def _ref_cfg(cfg) -> dict:
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
            "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab,
            "num_hidden_layers": cfg.n_layers,
            "hybrid_override_pattern": cfg.pattern,
            "mamba_num_heads": cfg.mamba_heads,
            "mamba_head_dim": cfg.mamba_head_dim,
            "n_groups": cfg.mamba_groups, "ssm_state_size": cfg.ssm_state,
            "conv_kernel": cfg.conv_kernel, "rms_norm_eps": cfg.norm_eps}


def _leaves(state):
    return [state["kv"][k] for k in sorted(state["kv"])] \
        + [state["mamba2"][k] for k in ("conv", "ssm")]


def test_graph_round_equals_eager_round_and_reference(card):
    """Three slots, prompts of 21, 32 and 40 tokens (inside a chunk of 16,
    on its edge, past two): rounds replayed from a captured CUDA graph
    give the eager fused rounds' tokens and decode states (the KV cache,
    the Mamba-2 conv window and SSM state, written in place at the same
    addresses) to the bit, with every shard up and with shard 1 dead;
    each stream is the reference's greedy stream. The reference's logits
    are read at each served position: the served token's lies at most
    1e-4 below the best (float32 sums in other orders; logits up to ~5)."""
    from repro_torch.runtime.executor import SlotPoolExecutor
    stepper, raw = _stepper()
    cfg = stepper.model.cfg
    graph, eager = (SlotPoolExecutor(stepper, 3, overlap=False,
                                     use_fused=True, use_graphs=g)
                    for g in (True, False))
    ptrs = [t.data_ptr() for t in _leaves(graph.state)]
    full = np.ones(4, bool)
    dead = np.array([True, False, True, True])
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (21, 32, 40)]
    served = [[] for _ in prompts]
    for slot, prompt in enumerate(prompts):
        tok = graph.admit(slot, prompt, full)
        assert tok == eager.admit(slot, prompt, full)
        served[slot].append(tok)
    for valid in [full, full, dead, dead, full, full]:
        got = graph.step_round(valid)
        assert got == eager.step_round(valid)
        for slot, _, tok in got:
            served[slot].append(tok)
    for a, b in zip(_leaves(graph.state), _leaves(eager.state)):
        assert torch.equal(a, b)
    assert [t.data_ptr() for t in _leaves(graph.state)] == ptrs
    assert (graph.vstep.n_captures, graph.vstep.n_replays) == (2, 6)
    for prompt, toks in zip(prompts, served):
        seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]),
                              device="cuda")
        logits = card.forward(_ref_cfg(cfg), raw, seq)[len(prompt) - 1:]
        picked = torch.as_tensor(toks, device="cuda")
        gap = logits.max(-1).values - logits.gather(1, picked[:, None])[:, 0]
        assert gap.max().item() <= 1e-4


def test_warmed_prefill_makes_no_synchronisation(card, monkeypatch):
    """Once warmed, ``model.decode`` inside ``ModelStepper.prefill`` makes
    no synchronising call (sync debug mode "error"), with a timing
    recorder attached: the chunked SSD, the conv and the state writes
    stay on the device, and each Mamba-2 mixer is one CUDA event pair of
    ``prefill.mamba``, read after the prefill's end event (3 pairs, device
    ms above 0). The prefill's last-position logits equal the reference's."""
    from repro_torch.models.zoo import Model
    from repro_torch.obs.tracer import FlightRecorder
    stepper, raw = _stepper()
    rec = FlightRecorder(timing=True)
    rec.attach("cuda")
    stepper.tracer = rec
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, stepper.model.cfg.vocab, (1, 40))}
    full = np.ones(4, bool)
    stepper.prefill(batch, full)
    torch.cuda.synchronize()
    decode = Model.decode

    def strict(self, *a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return decode(self, *a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    monkeypatch.setattr(Model, "decode", strict)
    logits, _ = stepper.prefill(batch, full)
    stepper.last_prefill_events[1].synchronize()
    pairs = stepper.last_prefill_mamba
    assert len(pairs) == 3
    assert sum(s.elapsed_time(e) for s, e in pairs) > 0
    assert stepper.last_prefill_chunks == 3 * 3
    want = card.forward(_ref_cfg(stepper.model.cfg), raw,
                        torch.as_tensor(batch["tokens"][0], device="cuda"))
    torch.testing.assert_close(logits[0, -1], want[-1], rtol=1e-4,
                               atol=1e-4)
    rec.detach()
