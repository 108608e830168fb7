"""The port's coding core against the reference, on the same numpy inputs.

Also ``max_decode_condition`` (equal), ``encode_outputs`` and
``pad_for_code``, and the coded convolution (``core.conv``: ``im2col``,
``conv2d_gemm``, ``coded_conv2d``) against the reference's functions,
against ``torch.nn.functional.conv2d``, and under every dead filter shard.

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

import torch.nn.functional as F

from repro.core import coded_layer as jcl
from repro.core import coding as jcoding
from repro.core import conv as jconv
from repro_torch.core import coded_layer as tcl
from repro_torch.core import coding as tcoding
from repro_torch.core import conv as tconv

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


# ------------------------------------------ the rest of the coding core ----

@pytest.mark.parametrize("T,r", [(T, r) for T in (1, 2, 4, 8, 12)
                                 for r in range(0, min(T, 4) + 1)])
def test_max_decode_condition_equal(T, r):
    """The worst condition number over the full-r erasure patterns (12
    choose 4 = 495 patterns at the widest), equal to the reference's."""
    got = tcoding.max_decode_condition(tcoding.CodeSpec(T, r))
    assert got == jcoding.max_decode_condition(jcoding.CodeSpec(T, r))
    assert got >= 1.0


@pytest.mark.parametrize("T,r", TR)
def test_encode_outputs(T, r):
    y = np.random.default_rng(5).normal(size=(T, 3, 7)).astype(np.float32)
    got = tcoding.encode_outputs(torch.from_numpy(y), tcoding.CodeSpec(T, r))
    assert got.dtype == torch.float32 and got.shape == (r, 3, 7)
    _close(got, jcoding.encode_outputs(jnp.asarray(y),
                                       jcoding.CodeSpec(T, r)))


@pytest.mark.parametrize("m,T,align", [(100, 4, 8), (128, 4, 8),
                                       (4096, 12, 8), (5, 3, 1),
                                       (151936, 16, 128), (1, 1, 8)])
def test_pad_for_code_equal(m, T, align):
    got = tcl.pad_for_code(m, T, align)
    assert got == jcl.pad_for_code(m, T, align)
    assert got >= m and got % (T * T * align) == 0


# ------------------------------------------------- coded convolution ----

def _conv_inputs(seed, shape, fshape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=fshape).astype(np.float32))


@pytest.mark.parametrize("f,stride,padding", [(3, 1, "SAME"), (3, 2, "SAME"),
                                              (2, 1, "SAME"), (3, 1, "VALID"),
                                              (3, 2, "VALID")])
def test_im2col_and_conv2d_gemm_match_reference(f, stride, padding):
    """The unroll to the bit (it moves values), the GEMM form within 1e-5
    of the reference's, and (stride 1, or VALID) within 1e-4 of
    ``F.conv2d`` with the reference's padding split (the low side gets
    (f - 1) // 2)."""
    x, filt = _conv_inputs(f, (2, 8, 7, 3), (f, f, 3, 8))
    np.testing.assert_array_equal(
        tconv.im2col(torch.from_numpy(x), f, stride, padding).numpy(),
        np.asarray(jconv.im2col(jnp.asarray(x), f, stride, padding)))
    got = tconv.conv2d_gemm(torch.from_numpy(x), torch.from_numpy(filt),
                            stride, padding)
    want = np.asarray(jconv.conv2d_gemm(jnp.asarray(x), jnp.asarray(filt),
                                        stride, padding))
    assert tuple(got.shape) == want.shape
    _close(got, want)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    if padding == "SAME":
        xt = F.pad(xt, ((f - 1) // 2, f // 2, (f - 1) // 2, f // 2))
    lib = F.conv2d(xt, torch.from_numpy(filt).permute(3, 2, 0, 1),
                   stride=stride).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), lib.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("layout", ["folded", "dedicated"])
def test_coded_conv_recovers_every_dead_filter_shard(layout):
    """Channel splitting (paper Fig. 8) at T = 4, r = 2: the filters'
    parity encoded offline from the unrolled weights; under the all-valid
    mask and every dead filter shard (two at a time on the dedicated
    layout) the output within 1e-5 of the reference's and within 1e-4 of
    the uncoded convolution."""
    T = 4
    jspec, tspec = _specs(T, 2, layout)
    x, filt = _conv_inputs(12, (2, 6, 6, 3), (3, 3, 3, T * T * 2))
    wmat = filt.reshape(-1, filt.shape[-1])
    jp = jcl.make_parity_weights(jnp.asarray(wmat), jspec)
    tp = tcl.make_parity_weights(torch.from_numpy(wmat), tspec)
    want = tconv.conv2d_gemm(torch.from_numpy(x), torch.from_numpy(filt))
    for mask in inbudget_masks(T, tspec.max_device_failures):
        got = tconv.coded_conv2d(torch.from_numpy(x), torch.from_numpy(filt),
                                 tp, tspec, np.array(mask))
        _close(got, jconv.coded_conv2d(jnp.asarray(x), jnp.asarray(filt), jp,
                                       jspec, jnp.asarray(mask)),
               f"{layout} mask={mask}")
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=f"mask={mask}")
