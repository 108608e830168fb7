"""The prefill's coded GEMMs decoded by the decode-and-merge kernel on the
card (``-m cuda``; skipped without one). No JAX here.

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_prefill_decode_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch


@pytest.mark.cuda
def test_warmed_prefill_forward_makes_no_synchronisation(monkeypatch):
    """granite-3-8b at full width in 4 layers, a 1020-token prompt: once
    the decode plans are cached, ``model.decode`` inside
    ``ModelStepper.prefill`` makes no synchronising call (sync debug mode
    "error"), the kernel launches once per coded GEMM (5 a layer and the
    head), and the logits equal the reference-decode prefill's (the
    reference decode put in the kernel's place) to the bit with every
    shard valid. With shard 2 dead both recoveries carry float32
    rounding: the reference decode's logits lie up to ~6e-5 from the
    fault-free ones at this width (logits up to ~4.4), so the two are held
    to each other within 1e-4 and the kernel's distance from the
    fault-free logits to at most twice the reference decode's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import get_arch
    from repro_torch.device import set_true_f32
    from repro_torch.core.coded_layer import decode_and_merge
    from repro_torch.kernels import ops
    from repro_torch.kernels.cdc_matmul import cdc_decode_merge
    from repro_torch.models import TPCtx, build
    from repro_torch.models.zoo import Model
    from repro_torch.serve import ModelStepper
    set_true_f32()
    cfg = dataclasses.replace(get_arch("granite-3-8b"), n_layers=4)
    model = build(cfg, TPCtx(tp=4, mode="coded", code_r=2))
    stepper = ModelStepper(model, model.init(0, device="cuda"),
                           max_len=2048)
    assert stepper.fused_prefill_on
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (1, 1020))}
    full = np.ones(4, bool)
    one = full.copy()
    one[2] = False
    for mask in (full, one):          # kernel builds, plans per mask
        stepper.prefill(batch, mask)
    torch.cuda.synchronize()

    decode = Model.decode

    def strict(self, *a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return decode(self, *a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def reference(ys, parity, spec, valid, *, valid_parity=None):
        return decode_and_merge(ys, parity, spec, valid,
                                valid_parity=valid_parity)

    def prefill(mask, fused):
        """The logits of one prefill and its kernel-3 launches; ``fused``
        false puts the reference decode in the kernel's place."""
        launches = cdc_decode_merge.launches
        with monkeypatch.context() as m:
            if fused:
                m.setattr(Model, "decode", strict)
            else:
                m.setattr(ops, "fused_decode_merge", reference)
            logits, _ = stepper.prefill(batch, mask)
        torch.cuda.synchronize()
        assert stepper.last_prefill_decode == "fused"
        return logits, cdc_decode_merge.launches - launches

    got = {}
    for name, mask in (("full", full), ("one", one)):
        got[name], launched = prefill(mask, True)
        assert launched == 5 * cfg.n_layers + 1
    clean, launched = prefill(full, False)
    assert launched == 0
    assert torch.equal(got["full"], clean)
    want, _ = prefill(one, False)
    torch.testing.assert_close(got["one"], want, rtol=1e-5, atol=1e-4)
    err = (got["one"] - clean).abs().max().item()
    assert err <= 2 * (want - clean).abs().max().item()
