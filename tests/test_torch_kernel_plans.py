"""Launch plans of the weight-streaming kernels, on the CPU.

Kernel 1 (``cdc_matmul.coded_plan``) and kernel 7 (``matmul.matmul_plan``)
cut a launch into blocks: column tiles inside parity slices, row blocks,
and k split across blocks with the partials added in split order. The
plans are plain Python, so their coverage is checked here at granite-3-8b's
widths on a 132-SM card. A plain emulation of each plan (each unit's
partial sums, decoded per split for kernel 1, then added in split order)
is held against the JAX package: kernel 1 against its oracle
``cdc_coded_matmul_ref`` and its Pallas kernel in interpret mode, kernel 7
against ``ops.matmul`` (its Pallas kernel in interpret mode), at 1e-4,
the reference's own kernel-vs-oracle bound (the split order changes the
float32 rounding, not the result).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coded_layer as jcl
from repro.core import coding as jcoding
from repro.kernels import cdc_matmul as jcdc
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import coded_layer as tcl
from repro_torch.core import coding as tcoding
from repro_torch.kernels import cdc_matmul as tcdc
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import stream_plan

KTOL = dict(rtol=1e-4, atol=1e-4)
CODES = [(2, 1), (2, 2), (4, 1), (4, 2), (4, 3), (4, 4), (8, 1), (8, 2),
         (8, 3), (8, 4)]
# granite-3-8b's coded GEMM widths: wq, wk (= wv), w1 (= w3)
GRANITE_WIDTHS = (4096, 1024, 12800)
N_SM, OCC = 132, 2


def check_cover(plan, rows, k, m_l, slice_width=None):
    """Every (column tile, row block) has its k ranges tile [0, k) in
    launch order, the tiles cover [0, m_l) once, the row blocks cover the
    rows, and no tile straddles a slice."""
    by_tile = {}
    for c0, width, r0, kb0, kb1 in plan.units():
        assert width >= 1 and kb1 > kb0
        if slice_width:
            assert c0 // slice_width == (c0 + width - 1) // slice_width, \
                f"tile [{c0}, {c0 + width}) straddles a slice"
        by_tile.setdefault((c0, width, r0), []).append((kb0, kb1))
    for key, ranges in by_tile.items():
        assert ranges[0][0] == 0 and ranges[-1][1] == k, (key, ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:])), ranges
    cols = sorted({(c0, w) for c0, w, _ in by_tile})
    assert cols[0][0] == 0 and sum(w for _, w in cols) == m_l
    assert all(a[0] + a[1] == b[0] for a, b in zip(cols, cols[1:]))
    r0s = sorted({r0 for _, _, r0 in by_tile})
    assert r0s == list(range(0, rows, plan.rb))
    assert len(by_tile) == len(cols) * len(r0s)


def check_limits(plan, streams):
    """What the CUDA side refuses (csrc/cdc_coded_matmul.cu, matmul.cu)."""
    pitch = -(-plan.bn // 4) * 4
    assert 1 <= plan.bn <= stream_plan.BN[plan.rb]
    assert 1 <= plan.ks <= 256
    assert streams * stream_plan.box_floats(plan.ks, pitch) \
        <= stream_plan.STAGE_FLOATS
    assert 1 <= plan.kchunk <= stream_plan.kmax(plan.rb)
    assert plan.aligned is False or (plan.bn % 4 == 0 and plan.wd % 4 == 0)


@pytest.mark.parametrize("rows", [1, 4, 5, 8, 16, 64])
@pytest.mark.parametrize("layout", ["folded", "dedicated"])
@pytest.mark.parametrize("T,r", CODES)
def test_coded_plan_covers_granite_shapes(T, r, layout, rows):
    k = 4096
    for width in GRANITE_WIDTHS:
        m_l = width // T
        plan = tcdc.coded_plan(rows, k, m_l, T, r, layout, N_SM, OCC)
        wd = m_l // T if layout == "folded" else m_l
        assert plan.wd == wd
        wide = (T if layout == "folded" else 1) * -(-wd // 128) >= 16
        assert plan.rb == (4 if rows <= 4 else 8 if rows <= 8 or not wide
                           else 16)
        assert plan.aligned, f"granite m_l={m_l} must take the bulk copies"
        assert plan.variant == f"rb{plan.rb}-async"
        check_limits(plan, T + r)
        check_cover(plan, rows, k, m_l, wd if layout == "folded" else None)
        assert plan.counters == plan.tiles * plan.nrb
        assert plan.blocks == len(plan.units())


@pytest.mark.parametrize("m_l,rows,layout,k", [(100, 3, "folded", 1000),
                                               (7, 9, "dedicated", 999)])
def test_coded_plan_ragged_shapes_take_ordinary_loads(m_l, rows, layout, k):
    """The ragged check shapes (chip_smoke's phase 2) cannot take the copy
    engine: their plan is the ordinary-load instantiation of the same
    kernel, and still covers the output once."""
    plan = tcdc.coded_plan(rows, k, m_l, 4, 2, layout, N_SM, OCC)
    assert not plan.aligned and plan.variant.endswith("-loads")
    wd = m_l // 4 if layout == "folded" else m_l
    check_limits(plan, 6)
    check_cover(plan, rows, k, m_l, wd if layout == "folded" else None)


def test_coded_plan_alignment_needs_strides_and_pointers():
    assert tcdc.coded_plan(4, 4096, 1024, 4, 2, "folded", N_SM, OCC).aligned
    assert not tcdc.coded_plan(4, 4096, 1024, 4, 2, "folded", N_SM, OCC,
                               ldw=4097).aligned
    assert not tcdc.coded_plan(4, 4096, 1024, 4, 2, "folded", N_SM, OCC,
                               ptr_aligned=False).aligned


def test_coded_plan_fills_the_card_at_decode_rows():
    """At the decode round's 4 rows (one block an SM, as the card reports
    for the 4-row instantiations) each granite GEMM's blocks fill at least
    80% of whole waves of the 132 resident blocks (k splits are whole
    stages, at most MAX_SPLITS of them)."""
    for width in GRANITE_WIDTHS:
        for r in (2, 4):
            plan = tcdc.coded_plan(4, 4096, width // 4, 4, r, "folded",
                                   N_SM, 1)
            eff = plan.blocks / (-(-plan.blocks // N_SM) * N_SM)
            assert eff >= 0.8, (width, r, plan, eff)


@pytest.mark.parametrize("shape,path,aligned", [
    ((512, 512, 512), "square", True),
    ((4, 4096, 4096), "rows", True),
    ((100, 300, 70), "square", False),
    ((16, 4096, 4096), "rows", True),
    ((5, 300, 70), "rows", False)])
def test_matmul_plan_covers(shape, path, aligned):
    m, k, n = shape
    plan = tmm.matmul_plan(m, n, k, False, N_SM, OCC)
    assert plan.path == path and plan.aligned == aligned
    assert plan.variant.startswith(path)
    if plan.stream is not None:
        assert plan.stream.rb == (4 if m <= 4 else 8 if m <= 8 or n < 1921
                                  else 16)
        check_limits(plan.stream, 1)
        check_cover(plan.stream, m, k, n)
    else:
        units = plan.units()
        assert len(units) == -(-n // tmm.SQ_BN) * -(-m // tmm.SQ_BM)
        assert sum(w for _, w, r0, _, _ in units if r0 == 0) == n


def test_matmul_plan_bf16_takes_the_square_loads_path():
    plan = tmm.matmul_plan(4, 512, 512, True, N_SM, OCC)
    assert plan.path == "square" and not plan.aligned


# ------------------------------------------------- plan emulations ----

def masks(T):
    return [(True,) * T] + [tuple(i != d for i in range(T))
                            for d in range(T)]


def emulate_coded(plan, x, w, wc, layout, T, r, gen, esel, coef, valid):
    """Kernel 1's arithmetic as its plan runs it: per unit the T + r
    partial GEMMs of its k range (parity read in its stored layout, as the
    kernel addresses it), the Eq. 12 decode of those partials (dead
    shards zeroed by select), then the splits added in split order."""
    rows, k = x.shape
    m_l = w.shape[1] // T
    parts = np.zeros((plan.ksplit, rows, T, m_l), np.float32)
    for c0, width, r0, kb0, kb1 in plan.units():
        split = kb0 // plan.kchunk
        rs = slice(r0, min(rows, r0 + plan.rb))
        cs = slice(c0, c0 + width)
        xs = x[rs, kb0:kb1]
        y = np.stack([xs @ w[kb0:kb1, t * m_l + c0:t * m_l + c0 + width]
                      for t in range(T)])
        if layout == "folded":
            s, o0 = divmod(c0, plan.wd)
            p = np.stack([xs @ wc[(s + j + 1) % T, kb0:kb1,
                                  j * plan.wd + o0:j * plan.wd + o0 + width]
                          for j in range(r)])
        else:
            p = np.stack([xs @ wc[j, kb0:kb1, cs] for j in range(r)])
        live = np.array(valid)[:, None, None]
        yz = np.where(live, y, np.float32(0))
        e = esel[cs]
        g = gen[e]                                       # [width, T]
        resid = p[e, :, np.arange(width)].T - np.einsum("cT,Tbc->bc", g, yz)
        miss = resid * coef[cs][None]
        parts[split, rs, :, cs] = np.where(live, yz, miss[None]) \
            .transpose(1, 0, 2)
    out = parts[0].copy()
    for sp in range(1, plan.ksplit):
        out = out + parts[sp]
    return out


@pytest.mark.parametrize("T,r,layout", [(4, 2, "folded"), (4, 4, "folded"),
                                        (4, 3, "dedicated"),
                                        (8, 3, "folded")])
def test_coded_plan_emulation_matches_reference(T, r, layout):
    """The split plan decodes each split's partials and adds them in split
    order: equal to the reference oracle and its Pallas kernel
    (interpret) within 1e-4 under every mask with <= 1 dead shard, with
    the dead shard's weights (and, folded, its parity slot) NaN."""
    rows, k, m_l = 5, 2100, 4 * T
    rng = np.random.default_rng(7)
    x = rng.normal(size=(rows, k)).astype(np.float32)
    w = (rng.normal(size=(k, T * m_l)) / np.sqrt(k)).astype(np.float32)
    jspec = jcl.CodedDenseSpec(jcoding.CodeSpec(T, r), layout=layout)
    tspec = tcl.CodedDenseSpec(tcoding.CodeSpec(T, r), layout=layout)
    wc = np.asarray(jcl.make_parity_weights(jnp.asarray(w), jspec))
    # a small card, so that k is split and the splits are exercised
    plan = tcdc.coded_plan(rows, k, m_l, T, r, layout, 3, 2)
    assert plan.ksplit > 1 and plan.nrb == 1 and plan.rb == 8
    gen = np.asarray(jcoding.generator_matrix(T, r), np.float32)
    for valid in masks(T):
        wn, wcn = w.copy(), wc.copy()
        dead = [d for d in range(T) if not valid[d]]
        for d in dead:
            wn[:, d * m_l:(d + 1) * m_l] = np.nan
            if layout == "folded":
                wcn[d] = np.nan
        te, tc = tcdc.eq12_plan(tspec, torch.tensor(valid),
                                torch.tensor(valid), m_l)
        got = emulate_coded(plan, x, wn, wcn, layout, T, r, gen,
                            te.numpy(), tc.numpy(), valid)
        assert np.isfinite(got).all(), f"NaN spread (mask {valid})"
        je, jc = jcdc.eq12_plan(jspec, jnp.asarray(valid),
                                jnp.asarray(valid), m_l)
        w_sh = jnp.asarray(w).reshape(k, T, m_l).transpose(1, 0, 2)
        pw = jnp.asarray(wc) if layout == "dedicated" else \
            jcl.unfold_parity(jnp.asarray(wc), T, r)
        args = (jnp.asarray(x), w_sh, pw, jnp.asarray(gen), je, jc,
                jnp.asarray(valid))
        oracle = np.asarray(jref.cdc_coded_matmul_ref(*args))
        np.testing.assert_allclose(got, oracle, err_msg=f"mask {valid}",
                                   **KTOL)
        pallas = np.asarray(jcdc.cdc_coded_matmul_pallas(*args,
                                                         interpret=True))
        np.testing.assert_allclose(got, pallas, err_msg=f"mask {valid}",
                                   **KTOL)


def emulate_matmul(plan, x, w):
    """Kernel 7's arithmetic as its plan runs it: per unit the partial
    product of its k range, then the splits added in split order."""
    m, n = x.shape[0], w.shape[1]
    sp = plan.stream
    nsplit = sp.ksplit if sp is not None else 1
    rb = sp.rb if sp is not None else tmm.SQ_BM
    parts = np.zeros((nsplit, m, n), np.float32)
    for c0, width, r0, kb0, kb1 in plan.units():
        split = kb0 // sp.kchunk if sp is not None else 0
        rs = slice(r0, min(m, r0 + rb))
        parts[split, rs, c0:c0 + width] = \
            x[rs, kb0:kb1] @ w[kb0:kb1, c0:c0 + width]
    out = parts[0].copy()
    for s in range(1, nsplit):
        out = out + parts[s]
    return out


# (the reference's Pallas GEMM takes k a multiple of 128, and m and n up
# to 128 or multiples of 128)
@pytest.mark.parametrize("m,k,n", [(4, 1024, 256), (16, 1280, 128),
                                   (5, 384, 70), (100, 256, 70),
                                   (64, 128, 96)])
def test_matmul_plan_emulation_matches_reference(m, k, n):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    plan = tmm.matmul_plan(m, n, k, False, 4, 2)
    if plan.path == "rows":
        assert plan.stream.ksplit > 1
    got = emulate_matmul(plan, x, w)
    want = np.asarray(jops.matmul(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, want, **KTOL)
    np.testing.assert_allclose(
        got, tmm.matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        **KTOL)


def test_plans_are_cached_per_shape():
    a = tcdc.coded_plan(4, 4096, 3200, 4, 2, "folded", N_SM, OCC)
    assert tcdc.coded_plan(4, 4096, 3200, 4, 2, "folded", N_SM, OCC) is a
    assert list(itertools.islice(a.units(), 1))[0][:3] == (0, a.bn, 0)
