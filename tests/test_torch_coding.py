"""The port's coding core against the reference, on the same numpy inputs.

T in {2, 4} x r in {1, 2}, and T = 4 x r in {3, 4} (the geometries the
adaptive planner reaches), x both parity layouts x every in-budget mask,
float32, atol = rtol = 1e-5 (both sides accumulate in float32; only the
summation order differs). A solve for 2+ dead shards with r >= 3 is
held at 1e-4 (``solve_tol``): the generator rows of degree >= 2 make the
system ill-conditioned (condition number ~1e3), which amplifies the
float32 rounding of the residuals, so the two packages' last bits differ
by up to ~3e-5 there, while both stay within 1e-4 of x @ w.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coded_layer as jcl
from repro.core import coding as jcoding
from repro_torch.core import coded_layer as tcl
from repro_torch.core import coding as tcoding

TOL = dict(rtol=1e-5, atol=1e-5)


def solve_tol(r: int, mask) -> dict:
    if r >= 3 and len(mask) - sum(mask) >= 2:
        return dict(rtol=1e-4, atol=1e-4)
    return TOL
TR = [(2, 1), (2, 2), (4, 1), (4, 2), (4, 3), (4, 4)]
CASES = [(T, r, layout) for T, r in TR for layout in ("folded", "dedicated")]


def inbudget_masks(T, budget):
    masks = [(True,) * T]
    for f in range(1, budget + 1):
        for dead in itertools.combinations(range(T), f):
            masks.append(tuple(i not in dead for i in range(T)))
    return masks


def _specs(T, r, layout):
    return (jcl.CodedDenseSpec(jcoding.CodeSpec(T, r), layout=layout),
            tcl.CodedDenseSpec(tcoding.CodeSpec(T, r), layout=layout))


def _close(t, j, msg="", tol=TOL):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j),
                               err_msg=msg, **tol)


@pytest.mark.parametrize("T,r", [(T, r) for T in (1, 2, 4, 8)
                                 for r in range(0, min(T, 3) + 1)])
def test_generator_matrix_equal(T, r):
    np.testing.assert_array_equal(tcoding.generator_matrix(T, r),
                                  jcoding.generator_matrix(T, r))


@pytest.mark.parametrize("T,r", TR)
def test_encode_weights(T, r):
    w = np.random.default_rng(0).normal(size=(T, 16, 12)).astype(np.float32)
    _close(tcoding.encode_weights(torch.from_numpy(w),
                                  tcoding.CodeSpec(T, r)),
           jcoding.encode_weights(jnp.asarray(w), jcoding.CodeSpec(T, r)))


@pytest.mark.parametrize("T,r", TR)
def test_decode_outputs_every_mask(T, r):
    rng = np.random.default_rng(1)
    y = rng.normal(size=(T, 3, 5)).astype(np.float32)
    jspec, tspec = jcoding.CodeSpec(T, r), tcoding.CodeSpec(T, r)
    par = np.asarray(jcoding.encode_outputs(jnp.asarray(y), jspec))
    for mask in inbudget_masks(T, r):
        garbage = y.copy()
        garbage[~np.array(mask)] = 1e3          # erased entries: garbage
        j = jcoding.decode_outputs(jnp.asarray(garbage), jnp.asarray(par),
                                   jnp.asarray(mask), jspec)
        t = tcoding.decode_outputs(torch.from_numpy(garbage),
                                   torch.from_numpy(par.copy()),
                                   np.array(mask),
                                   tspec)
        _close(t, j, f"T={T} r={r} mask={mask}")
        np.testing.assert_allclose(t.numpy(), y, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("T,r,layout", CASES)
def test_parity_weights_and_unfold(T, r, layout):
    jspec, tspec = _specs(T, r, layout)
    w = np.random.default_rng(2).normal(size=(24, T * T * 3)) \
        .astype(np.float32)
    jp = jcl.make_parity_weights(jnp.asarray(w), jspec)
    tp = tcl.make_parity_weights(torch.from_numpy(w), tspec)
    _close(tp, jp)
    # stacked [L, k, m] encodes layer by layer to the same leaves
    w3 = np.stack([w, 2 * w])
    _close(tcl.make_parity_weights(torch.from_numpy(w3), tspec),
           jcl.make_parity_weights(jnp.asarray(w3), jspec))
    if layout == "folded":
        _close(tcl.unfold_parity(tp, T, r), jcl.unfold_parity(jp, T, r))
        np.testing.assert_array_equal(tcl.folded_slot_map(T, r),
                                      jcl.folded_slot_map(T, r))


@pytest.mark.parametrize("T,r", TR)
def test_decode_folded_every_mask(T, r):
    jspec, tspec = _specs(T, r, "folded")
    rng = np.random.default_rng(3)
    m_l = 2 * T
    ys = rng.normal(size=(T, 2, 3, m_l)).astype(np.float32)
    p = rng.normal(size=(T, 2, 3, r * m_l // T)).astype(np.float32)
    for mask in inbudget_masks(T, max(r // 2, 1)):
        v = np.array(mask)
        yz = np.where(v[:, None, None, None], ys, 0).astype(np.float32)
        pz = np.where(v[:, None, None, None], p, 0).astype(np.float32)
        j = jcl.decode_folded(jnp.asarray(yz), jnp.asarray(pz),
                              jnp.asarray(v), jspec.code)
        t = tcl.decode_folded(torch.from_numpy(yz), torch.from_numpy(pz), v,
                              tspec.code)
        _close(t, j, f"T={T} r={r} mask={mask}")


@pytest.mark.parametrize("T,r,layout", CASES)
def test_coded_matmul_every_mask(T, r, layout):
    jspec, tspec = _specs(T, r, layout)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    w = (rng.normal(size=(32, T * T * 2)) / np.sqrt(32)).astype(np.float32)
    jp = jcl.make_parity_weights(jnp.asarray(w), jspec)
    tp = tcl.make_parity_weights(torch.from_numpy(w), tspec)
    for mask in inbudget_masks(T, jspec.max_device_failures):
        j = jcl.coded_matmul(jnp.asarray(x), jnp.asarray(w), jp, jspec,
                             jnp.asarray(mask))
        t = tcl.coded_matmul(torch.from_numpy(x), torch.from_numpy(w), tp,
                             tspec, np.array(mask))
        _close(t, j, f"{layout} T={T} r={r} mask={mask}",
               solve_tol(r, mask))
        np.testing.assert_allclose(t.numpy(), x @ w, rtol=1e-4, atol=1e-4)
    # uncoded: no mask is a plain merge of x @ w
    _close(tcl.coded_matmul(torch.from_numpy(x), torch.from_numpy(w), tp,
                            tspec, None), x @ w)
