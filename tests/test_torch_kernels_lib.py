"""The port's library kernels on the CPU against the reference package's
Pallas kernels (run in interpret mode, as tests/test_kernels.py runs
them), on the same numpy inputs: the blocked GEMM (kernel 7), the r=1
decode (kernel 5), the decode-and-merge (kernel 3) with its
``decode_and_merge(use_fused=True)`` entry, and the RMSNorm (kernel 6)
with the models' ``common.rmsnorm``. Then the coded-overhead study
(``launch.coded_overhead``) against the reference study.

Tolerances (float32): the GEMM 1e-4 (another summation order over k),
bf16 5e-2 (the reference's own bf16 matmul bound); the decodes 1e-5
(bf16 2e-2, one bf16 rounding of the output); RMSNorm 1e-6 (the same
float32 arithmetic, rsqrt rounding apart); the study's GEMM outputs 1e-4.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coded_layer as jcl
from repro.core import coding as jcoding
from repro.kernels import ops as jops
from repro.models import common as jcommon
from repro_torch.core import coded_layer as tcl
from repro_torch.core import coding as tcoding
from repro_torch.kernels import ops as tops
from repro_torch.models import common as tcommon


def close(t, j, tol, msg=""):
    np.testing.assert_allclose(np.asarray(t.to(torch.float32)),
                               np.asarray(j, np.float32), rtol=tol, atol=tol,
                               err_msg=msg)


def _pair(a: np.ndarray, dtype):
    """The same numpy array as a JAX and a torch array of ``dtype``."""
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


# ------------------------------------------------------------ kernel 7 --

@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 128, 384),
                                   (128, 512, 256), (384, 256, 128),
                                   (100, 96, 70)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_reference_kernel(m, k, n, dtype):
    rng = np.random.default_rng(m + k + n)
    jx, tx = _pair(rng.normal(size=(m, k)).astype(np.float32), dtype)
    jw, tw = _pair(rng.normal(size=(k, n)).astype(np.float32), dtype)
    got = tops.matmul(tx, tw)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    close(got, jops.matmul(jx, jw), 1e-4 if dtype == "float32" else 5e-2)
    f32 = tops.matmul(tx, tw, out_dtype=torch.float32)
    close(f32, jops.matmul(jx, jw, out_dtype=jnp.float32),
          1e-4 if dtype == "float32" else 5e-2)


# ------------------------------------------------------------ kernel 5 --

def _single_erasures(T):
    return [(True,) * T] + [tuple(i != d for i in range(T))
                            for d in range(T)]


@pytest.mark.parametrize("T", [2, 4, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cdc_decode_matches_reference_kernel(T, dtype):
    rng = np.random.default_rng(30 + T)
    y = rng.normal(size=(T, 16, 128)).astype(np.float32)
    jy, ty = _pair(y, dtype)
    jp, tp = _pair(y.sum(0), dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for mask in _single_erasures(T):
        got = tops.cdc_decode(ty, tp, np.array(mask))
        assert got.dtype == ty.dtype
        want = jops.cdc_decode(jy, jp, jnp.asarray(mask))
        close(got, want, tol, msg=f"T={T} {dtype} mask={mask}")
    two_dead = np.array([False, False] + [True] * (T - 2))
    with pytest.raises(ValueError, match="at most 1 erased"):
        tops.cdc_decode(ty, tp, two_dead)
    with pytest.raises(ValueError, match="at most 1 erased"):
        jops.cdc_decode(jy, jp, jnp.asarray(two_dead))


def test_cdc_decode_nan_in_dead_shard_propagates_as_reference():
    """Multiply semantics, as the reference writes them: a NaN in the dead
    shard reaches every shard's output at that element, in both."""
    rng = np.random.default_rng(40)
    y = rng.normal(size=(4, 16, 128)).astype(np.float32)
    p = y.sum(0)
    y[2, 3, 5] = np.nan
    mask = (True, True, False, True)
    got = tops.cdc_decode(torch.from_numpy(y), torch.from_numpy(p),
                          np.array(mask))
    want = np.asarray(jops.cdc_decode(jnp.asarray(y), jnp.asarray(p),
                                      jnp.asarray(mask)))
    np.testing.assert_array_equal(got.isnan().numpy(), np.isnan(want))
    assert got[:, 3, 5].isnan().all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ kernel 3 --

def _masks(T, budget):
    out = [(True,) * T]
    for f in range(1, budget + 1):
        for dead in itertools.combinations(range(T), f):
            out.append(tuple(i not in dead for i in range(T)))
    return out


@pytest.mark.parametrize("T,r,layout", [(T, r, layout) for T in (2, 4)
                                        for r in (1, 2)
                                        for layout in ("folded",
                                                       "dedicated")])
def test_decode_merge_matches_reference(T, r, layout):
    """Mirrors the reference's test_decode_merge_matches_reference: middle
    batch and sequence dimensions, every in-budget mask; the fused op ==
    the reference's fused op (Pallas, interpret) at 1e-5, the routed
    ``decode_and_merge(use_fused=True)`` == the fused op exactly, and a
    2+ dead mask takes the reference decode_and_merge exactly."""
    jspec = jcl.CodedDenseSpec(jcoding.CodeSpec(T, r), layout=layout)
    tspec = tcl.CodedDenseSpec(tcoding.CodeSpec(T, r), layout=layout)
    m_l = 2 * T if layout == "folded" else 7
    pshape = ((T, 2, 3, r * (m_l // T)) if layout == "folded"
              else (r, 2, 3, m_l))
    rng = np.random.default_rng(50 + 4 * T + r)
    ys = rng.normal(size=(T, 2, 3, m_l)).astype(np.float32)
    par = rng.normal(size=pshape).astype(np.float32)
    tys, tpar = torch.from_numpy(ys), torch.from_numpy(par)
    for mask in _masks(T, jspec.max_device_failures):
        v = np.array(mask)
        fused = tops.fused_decode_merge(tys, tpar, tspec, v)
        routed = tcl.decode_and_merge(tys, tpar, tspec, v, use_fused=True)
        assert fused.shape == (2, 3, T * m_l)
        np.testing.assert_array_equal(routed.numpy(), fused.numpy())
        want = jops.fused_decode_merge(jnp.asarray(ys), jnp.asarray(par),
                                       jspec, jnp.asarray(mask))
        close(fused, want, 1e-5, msg=f"{layout} T={T} r={r} mask={mask}")
        if T - sum(mask) > 1:
            np.testing.assert_array_equal(
                fused.numpy(), tcl.decode_and_merge(tys, tpar, tspec,
                                                    v).numpy())


def test_decode_merge_ignores_a_dead_shard_and_matches_coded_matmul():
    """Consistent shard and parity outputs of a coded GEMM: the fused
    decode of a dead (NaN) shard rebuilds the GEMM's output."""
    T, r = 4, 2
    tspec = tcl.CodedDenseSpec(tcoding.CodeSpec(T, r))
    rng = np.random.default_rng(60)
    x = torch.from_numpy(rng.normal(size=(5, 24)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(24, 32)).astype(np.float32))
    wc = tcl.make_parity_weights(w, tspec)
    ys = (x @ w).reshape(5, T, 8).movedim(1, 0).contiguous()
    par = torch.matmul(x[None], wc)                      # [T, 5, r*w]
    for d in range(T):
        yd = ys.clone()
        yd[d] = float("nan")
        v = np.array([i != d for i in range(T)])
        got = tcl.decode_and_merge(yd, par, tspec, v, use_fused=True)
        np.testing.assert_allclose(got.numpy(), (x @ w).numpy(), rtol=1e-4,
                                   atol=1e-4)


# ------------------------------------------------------------ kernel 6 --

@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_rmsnorm_matches_reference_kernel(eps):
    rng = np.random.default_rng(70)
    x = (3 * rng.normal(size=(8, 256))).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=256)).astype(np.float32)
    want = jops.rmsnorm(jnp.asarray(x), jnp.asarray(g), eps=eps)
    close(tops.rmsnorm(torch.from_numpy(x), torch.from_numpy(g), eps=eps),
          want, 1e-6)
    x3 = x.reshape(2, 4, 256)
    got = tcommon.rmsnorm({"g": torch.from_numpy(g)}, torch.from_numpy(x3),
                          eps)
    close(got, jcommon.rmsnorm({"g": jnp.asarray(g)}, jnp.asarray(x3), eps),
          1e-6)
    close(got.reshape(8, 256), want, 1e-6)


def test_kernel_cost_models_match_reference():
    cases = {
        "matmul": ([("float32", [512, 384])],
                   [("float32", [512, 256]), ("float32", [256, 384])]),
        "cdc_decode_merge": ([("float32", [4, 4, 256])],
                             [("bool", [4]), ("float32", [4, 4, 256])]),
        "cdc_decode": ([("float32", [8, 256, 512])],
                       [("bool", [8]), ("float32", [8, 256, 512])]),
        "rmsnorm": ([("float32", [4, 4096])], [("float32", [4, 4096])]),
    }
    for name, (out, ops_in) in cases.items():
        assert tops.KERNEL_COSTS[name](out, ops_in) == \
            jops.KERNEL_COSTS[f"{name}_pallas"](out, ops_in), name


# -------------------------------------------------- coded-overhead study --

def test_coded_overhead_study_matches_reference(monkeypatch):
    """run() at a small size gives the reference study's (T, r, FLOP
    overhead) rows, and its three coded_matmul outputs per row equal the
    reference's on the same inputs (1e-4). The r=1 folded rows decode
    with shard 1 dead, beyond the code's budget (it tolerates 0 device
    failures): their 'recovering' output is not x @ w in either package,
    and the two packages still agree. (The reference study's timer and
    encode are stubbed out there: only its sweep and row keys are compared
    with it; the outputs come from the reference's coded_matmul, jitted.)"""
    import jax
    from benchmarks import coded_overhead as jstudy
    from repro_torch.launch import coded_overhead as study
    rows = study.run(batch=4, k=64, m=256, device="cpu")
    key = ("T", "r", "flops_overhead_theory")
    monkeypatch.setattr(jstudy, "_time", lambda f, *a, n=20: 1.0)
    monkeypatch.setattr(jstudy, "make_parity_weights", lambda w, spec: None)
    want = jstudy.run(batch=4, k=64, m=256)
    assert [tuple(r[k] for k in key) for r in rows] == \
        [tuple(r[k] for k in key) for r in want]
    assert set(rows[0]) == set(want[0])
    coded_matmul = jax.jit(jcl.coded_matmul, static_argnums=(3,))
    encode = jax.jit(jcl.make_parity_weights, static_argnums=(1,))
    for c in study.study_cases(batch=4, k=64, m=256, device="cpu"):
        x, w = c.x.numpy(), c.w.numpy()
        jspec = jcl.CodedDenseSpec(jcoding.CodeSpec(c.T, c.r))
        jwc = encode(jnp.asarray(w), jspec)
        ones = jnp.ones(c.T, bool)
        for name, got, jvalid, jwcdc in (
                ("plain", c.plain(c.x), None, None),
                ("coded", c.coded(c.x), ones, jwc),
                ("recovering", c.recovering(c.x), jnp.asarray(c.valid),
                 jwc)):
            jout = coded_matmul(jnp.asarray(x), jnp.asarray(w), jwcdc,
                                jspec, jvalid)
            close(got, jout, 1e-4, msg=f"T={c.T} r={c.r} {name}")
        exact = x @ w
        err = float(np.abs(c.recovering(c.x).numpy() - exact).max())
        if c.r == 1:
            assert jspec.max_device_failures == 0 and err > 1.0, err
        else:
            assert err < 1e-4, err


def test_coded_overhead_kernels_rows_and_device_policy(monkeypatch):
    from repro_torch.launch import coded_overhead as study
    rows = study.run_kernels(device="cpu")
    assert [r["kernel"] for r in rows] == ["matmul", "cdc_decode"]
    assert all(set(r) == {"kernel", "us_kernel", "us_plain"} for r in rows)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        study.main([])
