"""Launch plans of the port's kernels, on the CPU.

Kernel 1 (``cdc_matmul.coded_plan``), kernel 2 (``cdc_decode.head_plan``)
and kernel 7 (``matmul.matmul_plan``) cut a launch into blocks: column
tiles inside parity slices, row blocks, and k split across blocks with the
partials added in split order. The plans are plain Python, so their
coverage is checked here at granite-3-8b's widths on a 132-SM card. A
plain emulation of each plan (each unit's partial sums, decoded per split
for kernel 1, added in split order and then decoded, masked and reduced
per tile for kernel 2) is held against the JAX package: kernel 1 against
its oracle ``cdc_coded_matmul_ref`` and its Pallas kernel in interpret
mode, kernel 2 against ``fused_head_argmax_ref`` and
``cdc_fused_head_argmax_pallas`` in interpret mode, kernel 7 against
``ops.matmul`` (its Pallas kernel in interpret mode), at 1e-4, the
reference's own kernel-vs-oracle bound (the split order changes the
float32 rounding, not the result). Kernel 6's plan (``rmsnorm_plan``) and
the order of its reduction are held against ``rmsnorm_pallas``.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coded_layer as jcl
from repro.core import coding as jcoding
from repro.kernels import cdc_decode as jdec
from repro.kernels import cdc_matmul as jcdc
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import rmsnorm as jrms
from repro_torch.configs import get_arch
from repro_torch.core import coded_layer as tcl
from repro_torch.core import coding as tcoding
from repro_torch.kernels import cdc_decode as tdec
from repro_torch.kernels import cdc_encode as tenc
from repro_torch.kernels import cdc_matmul as tcdc
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trms
from repro_torch.kernels import stream_plan
from repro_torch.models.common import TPCtx

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
    """What the CUDA side refuses (csrc/coded_matmul.cuh, fused_head.cuh,
    matmul.cu), in the plan's storage type."""
    v = 16 // plan.elem
    pitch = -(-plan.bn // v) * v + plan.lead
    assert pitch == plan.pitch <= 256
    assert 1 <= plan.bn <= stream_plan.BN[plan.rb]
    assert plan.rb != 16 or stream_plan.rb_fits(16, streams)
    assert 1 <= plan.ks <= 256
    assert streams * stream_plan.box_elems(plan.ks, pitch, plan.elem) \
        <= stream_plan.STAGE_BYTES // plan.elem
    assert 1 <= plan.kchunk <= stream_plan.kmax(plan.rb)
    assert plan.aligned is False or (plan.bn % v == 0
                                     and plan.wd % (v // 2) == 0)


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
    engine: their plan is the row-copy instantiation of the same kernel
    (box rows that hold each k row from its first 16-byte granule on),
    and still covers the output once."""
    plan = tcdc.coded_plan(rows, k, m_l, 4, 2, layout, N_SM, OCC)
    assert not plan.aligned and plan.variant.endswith("-rowcopy")
    wd = m_l // 4 if layout == "folded" else m_l
    check_limits(plan, 6)
    check_cover(plan, rows, k, m_l, wd if layout == "folded" else None)


def granite_widths_at(T):
    """granite-3-8b's coded GEMM widths at code width T as launch.serve
    builds them: heads padded for T (attn_dims), columns to T * T."""
    from repro_torch.models.attention import attn_dims
    cfg, ctx = get_arch("granite-3-8b"), TPCtx(tp=T)
    hq, hkv, _ = attn_dims(cfg, T)
    return tuple(ctx.pad_dim(n) for n in (hq * cfg.hd, hkv * cfg.hd,
                                          cfg.d_ff))


@pytest.mark.parametrize("rows", [1, 4, 5, 9, 17, 64])
@pytest.mark.parametrize("layout", ["folded", "dedicated"])
@pytest.mark.parametrize("T", [3, 6, 12])
def test_coded_plan_covers_granite_shapes_any_t(T, layout, rows):
    """The generic instantiation's plans at granite's widths for T = 3, 6
    and 12 and r in {1, 2, 4, T}: every stream's tile inside its slice, k
    covered in order, a stage at least one k row of every stream (up to
    24 streams), 16-row blocks only for <= 12 streams and 8-row blocks
    only for <= 24 (wider codes take 4-row blocks, however many rows)."""
    k = 4096
    for width in granite_widths_at(T):
        m_l = width // T
        for r in sorted({1, 2, 4, T}):
            plan = tcdc.coded_plan(rows, k, m_l, T, r, layout, N_SM, OCC)
            wd = m_l // T if layout == "folded" else m_l
            assert plan.wd == wd and plan.ks >= 1
            assert stream_plan.rb_fits(plan.rb, T + r)
            assert plan.rb == 4 or rows > 4
            if T + r > 24:
                assert plan.rb == 4
            check_limits(plan, T + r)
            check_cover(plan, rows, k, m_l,
                        wd if layout == "folded" else None)
            assert plan.blocks == len(plan.units())


def test_coded_plan_t12_w1_slices_take_ordinary_loads():
    """At T = 12 granite's w1 (d_ff 12800 padded to 12816, m_l 1068) has
    folded slices of 89 float32 columns, 4 bytes off a 16-byte boundary,
    and parity rows of 178 columns (712 bytes): the row-copy
    instantiation (``-rowcopy``: box rows that hold each k row from its
    first 16-byte granule on) takes them, its tiles the whole 89-column
    slices in box rows of 92 + 4 columns (a row's granules start up to 3
    columns before it); wq's 32-column and wk's 8-column slices take the
    copy engine."""
    wq, wk, w1 = (w // 12 for w in granite_widths_at(12))
    assert (wq, wk, w1) == (384, 96, 1068)
    for m_l, aligned in ((wq, True), (wk, True), (w1, False)):
        plan = tcdc.coded_plan(4, 4096, m_l, 12, 2, "folded", N_SM, OCC)
        assert plan.aligned is aligned and plan.wd == m_l // 12
        assert plan.variant == f"rb4-{'async' if aligned else 'rowcopy'}"
    plan = tcdc.coded_plan(4, 4096, w1, 12, 2, "folded", N_SM, 1)
    assert (plan.bn, plan.tps, plan.pitch, plan.lead) == (89, 1, 96, 4)


# every shape the copy engine cannot take, which kernel 1's row-copy
# instantiation serves: (T, r, m_l, layout, bytes an element, rows)
ROWCOPY_SHAPES = [
    (12, 2, 1068, "folded", 4, 4),      # T = 12's w1 and w3
    (12, 2, 1068, "folded", 4, 9),
    (12, 2, 1068, "folded", 2, 4),      # bf16: rows at odd elements
    (16, 2, 800, "folded", 2, 4),       # bf16 at T = 16: 100-byte slices
    (16, 1, 800, "folded", 4, 4),       # odd r at T = 16: parity rows of
    (16, 3, 800, "folded", 4, 9),       # 200 r bytes
    (16, 5, 800, "folded", 4, 4),       # 21 streams: 2 a consumer warp
    (16, 9, 800, "folded", 4, 4),       # 25 streams: 3 a consumer warp
    (4, 2, 1001, "dedicated", 4, 4),    # the dedicated layout, odd m_l
    (12, 2, 1001, "dedicated", 4, 5)]


@pytest.mark.parametrize("T,r,m_l,layout,elem,rows", ROWCOPY_SHAPES)
def test_rowcopy_plans_cover_misaligned_shapes(T, r, m_l, layout, elem,
                                               rows):
    """Each shape the copy engine cannot take gets the row-copy
    instantiation, and its plan covers every output column once, never
    straddles a slice, and fits what the C side checks (coded_plan_ok):
    box rows of whole 16-byte vectors, one vector wider than the tile (a
    row's granules start up to 15 bytes before it), at most 256 elements,
    a stage that holds one k row of every stream, the row block's
    epilogue, and at most 3 streams a consumer warp."""
    rb, aligned = tcdc.coded_variant(rows, m_l, T, r, layout, elem=elem)
    assert not aligned
    plan = tcdc.coded_plan(rows, 4096, m_l, T, r, layout, N_SM, OCC,
                           elem=elem)
    assert plan.rb == rb and not plan.aligned and plan.lead * elem == 16
    assert plan.variant == f"rb{rb}-rowcopy" + ("-bf16" if elem == 2
                                                else "")
    assert plan.pitch <= 256 and plan.pitch * elem % 16 == 0
    assert tcdc.streams_per_warp(T + r) <= 3
    check_limits(plan, T + r)
    wd = m_l // T if layout == "folded" else m_l
    check_cover(plan, rows, 4096, m_l, wd if layout == "folded" else None)
    assert plan.blocks == len(plan.units())


def test_encode_reads_16_byte_vectors_at_t12_w1():
    """Kernel 4 reads 16-byte vectors wherever the shard reads are whole
    vectors, even where the folded slices are not: granite's w1 leaf at T
    = 12 ([L, 4096, 12816] viewed as [L, 12, 4096, 1068] shards,
    89-column slices) reads 4 float32 columns at once. On bf16 a shard
    row of 1068 columns is 2136 bytes, no whole vectors, so it reads one
    column, as it does at a misaligned base or stride."""
    w = torch.empty((2, 16, 12 * 1068))
    sh = w.view(2, 16, 12, 1068).permute(0, 2, 1, 3)
    strides = (sh.stride(1), sh.stride(2), sh.stride(0))
    assert tenc.encode_vec(1068, strides, 0, 4) == 4
    assert tenc.encode_vec(1068, strides, 0, 2) == 1
    assert tenc.encode_vec(1072, (1072, 12 * 1072, 0), 0, 2) == 8
    assert tenc.encode_vec(1068, strides, 4, 4) == 1
    assert tenc.encode_vec(1067, (1067, 12 * 1067, 0), 0, 4) == 1


def test_coded_plan_up_to_32_streams():
    """(16, 16), the widest code: 32 streams, 4-row blocks at any rows,
    stages of at least one k row of every stream."""
    for rows in (4, 9, 64):
        for m_l, lead in ((256, 0), (800, 4)):
            plan = tcdc.coded_plan(rows, 4096, m_l, 16, 16, "folded", N_SM,
                                   OCC)
            assert plan.rb == 4 and plan.ks >= 1 and plan.lead == lead
            check_limits(plan, 32)
            check_cover(plan, rows, 4096, m_l, m_l // 16)


@pytest.mark.parametrize("rows", [1, 4, 5, 9, 17])
@pytest.mark.parametrize("T", [3, 6, 12])
def test_head_plan_covers_granite_head_any_t(T, rows):
    """Kernel 2's generic instantiation at granite's head for T = 3, 6 and
    12 (m_l 16386, 8196, 4104): the plan covers the head once, 16-row
    blocks only up to 11 shards."""
    k = 4096
    m_l = TPCtx(tp=T).pad_dim(get_arch("granite-3-8b").vocab) // T
    rb, aligned = tdec.head_variant(rows, m_l, T * m_l, m_l, True, T)
    assert aligned == (m_l % 4 == 0)
    assert stream_plan.rb_fits(rb, T + 1)
    plan = tdec.head_plan(rows, k, m_l, T, N_SM, 1, aligned)
    check_limits(plan, T + 1)
    check_cover(plan, rows, k, m_l)
    assert plan.blocks == len(plan.units())


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
                                        (8, 3, "folded"), (3, 2, "folded"),
                                        (12, 2, "folded")])
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


# ------------------------------------------------ kernel 2: fused head ----

GRANITE_VOCAB = get_arch("granite-3-8b").vocab


def head_width(T: int) -> int:
    """m_l of granite-3-8b's head shards at T (the vocabulary padded to a
    multiple of T * T, as the model pads it)."""
    return TPCtx(tp=T).pad_dim(GRANITE_VOCAB) // T


def card_occupancy(rb: int) -> int:
    """Resident blocks per SM the card reports for kernel 2 (one for the
    4-row blocks, which own an SM's shared memory)."""
    return 1 if rb == 4 else 2


@pytest.mark.parametrize("rows", [1, 4, 5, 8, 16, 64])
@pytest.mark.parametrize("T", [2, 4, 8])
def test_head_plan_covers_granite_head(T, rows):
    k, m_l = 4096, head_width(T)
    rb, aligned = tdec.head_variant(rows, m_l, T * m_l, m_l)
    # T = 4 (the serving default) and 8 give whole 16-byte rows; T = 2's
    # m_l = 24578 does not, and takes the row copies
    assert aligned == (T != 2) == (m_l % 4 == 0)
    assert rb == (4 if rows <= 4 else 8 if rows <= 8 else 16)
    plan = tdec.head_plan(rows, k, m_l, T, N_SM, card_occupancy(rb), aligned)
    assert plan.rb == rb and plan.n_slices == 1 and plan.wd == m_l
    assert plan.variant == f"rb{rb}-{'async' if aligned else 'rowcopy'}"
    check_limits(plan, T + 1)
    check_cover(plan, rows, k, m_l)
    assert plan.counters == plan.tiles * plan.nrb
    assert plan.blocks == len(plan.units())
    slots = N_SM * card_occupancy(rb)
    assert plan.blocks / (-(-plan.blocks // slots) * slots) >= 0.9


def test_head_plan_at_the_decode_round():
    """Granite's head at the decode round's 4 rows and T = 4: 49 tiles of
    252 columns (the last one 196 wide), stages of 6 k rows, 5 splits of
    822, 245 blocks of 4 rows on the copy engine."""
    plan = tdec.head_plan(4, 4096, 12292, 4, N_SM, 1)
    assert (plan.bn, plan.tiles, plan.ks, plan.ksplit, plan.kchunk,
            plan.blocks, plan.variant) == (252, 49, 6, 5, 822, 245,
                                           "rb4-async")
    assert plan.units()[48][:2] == (48 * 252, 196)


# whisper-medium at T = 4: k = d = 1024; wq (m_l 256, 64-column folded
# slices) and w1 (m_l 1024); the head's 51865 words padded to 51872
WHISPER = get_arch("whisper-medium")
WHISPER_HEAD = TPCtx(tp=4).pad_dim(WHISPER.vocab) // 4


@pytest.mark.parametrize("rows", [1, 4, 5, 16, 64])
@pytest.mark.parametrize("m_l", [256, 1024], ids=["wq", "w1"])
def test_coded_plan_covers_whisper_shapes(m_l, rows):
    """Kernel 1 at whisper's k = 1024 (a quarter of granite's stages): the
    copy engine's plan still covers the output once, every k split holds
    at least one row (the short last one included), within the kernel's
    limits; at the decode round's 4 rows (one block an SM) k splits into
    25 ranges of 42 rows (wq: 100 blocks) and 15 of 70 (w1: 120)."""
    plan = tcdc.coded_plan(rows, WHISPER.d_model, m_l, 4, 2, "folded",
                           N_SM, 1)
    assert plan.aligned and plan.wd == m_l // 4
    check_limits(plan, 6)
    check_cover(plan, rows, WHISPER.d_model, m_l, plan.wd)
    assert plan.blocks == len(plan.units())
    if rows == 4:
        assert (plan.ksplit, plan.kchunk) == \
            ((25, 42) if m_l == 256 else (15, 70))


@pytest.mark.parametrize("rows", [1, 4, 5, 16])
def test_head_plan_covers_whisper_head(rows):
    """Kernel 2 at whisper's head (m_l 12968, k 1024): whole 16-byte rows,
    so the copy engine; the plan covers the head once with the vocabulary
    cut (51865) inside the last tile; at 4 rows 51 tiles (the last 168
    wide) and 5 splits of 210."""
    k, m_l = WHISPER.d_model, WHISPER_HEAD
    rb, aligned = tdec.head_variant(rows, m_l, 4 * m_l, m_l)
    assert aligned and m_l == 12968
    plan = tdec.head_plan(rows, k, m_l, 4, N_SM, card_occupancy(rb),
                          aligned)
    check_limits(plan, 5)
    check_cover(plan, rows, k, m_l)
    cut = WHISPER.vocab - 3 * m_l
    assert (plan.tiles - 1) * plan.bn < cut < m_l
    if rows == 4:
        assert (plan.tiles, plan.ksplit, plan.kchunk) == (51, 5, 210)
        assert plan.units()[50][:2] == (50 * plan.bn, m_l - 50 * plan.bn)


def test_head_plan_emulation_at_whisper_head():
    """Kernel 2's plan at whisper's head, emulated on integer inputs with
    the largest logits planted in the padded columns 51865-51871: tokens
    and max equal to the oracle's (``fused_head_argmax_ref``) under every
    mask, and never a padded column."""
    T, b, k, m_l = 4, 4, WHISPER.d_model, WHISPER_HEAD
    rng = np.random.default_rng(29)
    x = rng.integers(1, 3, size=(b, k)).astype(np.float32)
    w = rng.integers(-1, 2, size=(k, T * m_l)).astype(np.float32)
    w[:, WHISPER.vocab:] = 16.0
    w_shards = np.ascontiguousarray(w.reshape(k, T, m_l).transpose(1, 0, 2))
    pw = w_shards.sum(0)
    plan = tdec.head_plan(b, k, m_l, T, N_SM, 1)
    for valid in masks(T):
        tok, vmax = emulate_head(plan, x, w_shards, pw, valid, WHISPER.vocab)
        jt, jm = jref.fused_head_argmax_ref(
            jnp.asarray(x), jnp.asarray(w_shards), jnp.asarray(pw),
            jnp.asarray(valid), WHISPER.vocab)
        np.testing.assert_array_equal(tok, np.asarray(jt))
        np.testing.assert_array_equal(vmax, np.asarray(jm))
        assert (tok < WHISPER.vocab).all()


@pytest.mark.parametrize("m_l,ldw,sstr,ptr_ok,rows,k", [
    (1001, 4 * 1001, 1001, True, 4, 4096),      # ragged m_l
    (1024, 4097, 1024, True, 9, 4096),          # odd row stride
    (1024, 4 * 1024, 1025, True, 5, 1000),      # odd shard offset
    (1024, 4 * 1024, 1024, False, 17, 4093)])   # misaligned base
def test_head_plan_ragged_shapes_take_ordinary_loads(m_l, ldw, sstr, ptr_ok,
                                                     rows, k):
    rb, aligned = tdec.head_variant(rows, m_l, ldw, sstr, ptr_ok)
    assert not aligned
    plan = tdec.head_plan(rows, k, m_l, 4, N_SM, card_occupancy(rb), aligned)
    assert plan.variant == f"rb{rb}-rowcopy"
    check_limits(plan, 5)
    check_cover(plan, rows, k, m_l)


def emulate_head(plan, x, w_shards, pw, valid, vocab):
    """Kernel 2's arithmetic as its plan runs it: per unit the S = T + 1
    raw partial sums of its k range (units come split by split), the
    splits added in split order, then the multiply-decode, the vocab mask
    and the tile's (max, id) per row, then the tiles reduced in tile order
    with ties to the smaller id. Returns (token int32 [b], max [b])."""
    b = x.shape[0]
    T, _, m_l = w_shards.shape
    sums = {}
    for c0, width, r0, kb0, kb1 in plan.units():
        xs = x[r0:r0 + plan.rb, kb0:kb1]
        y = np.stack([xs @ w_shards[t, kb0:kb1, c0:c0 + width]
                      for t in range(T)] + [xs @ pw[kb0:kb1, c0:c0 + width]])
        key = (c0, width, r0)
        sums[key] = y if key not in sums else sums[key] + y
    vm = np.asarray(valid, np.float32)[:, None, None]
    best = [(-np.inf, 2 ** 31 - 1)] * b
    for (c0, width, r0), tot in sorted(sums.items()):
        yz = tot[:T] * vm
        miss = tot[T] - yz.sum(0)
        rec = yz + (np.float32(1) - vm) * miss[None]
        # gid grows along the t-major flattening: argmax's first maximum
        # is the tile's smallest id among its ties
        gid = np.arange(T)[:, None] * m_l + c0 + np.arange(width)[None]
        logits = np.where((gid < vocab)[:, None, :], rec, np.float32(-1e30))
        for i in range(tot.shape[1]):
            flat = logits[:, i, :].ravel()
            j = int(np.argmax(flat))
            v, g = flat[j], int(gid.ravel()[j])
            bv, bg = best[r0 + i]
            if v > bv or (v == bv and g < bg):
                best[r0 + i] = (v, g)
    return (np.array([g for _, g in best], np.int32),
            np.array([v for v, _ in best], np.float32))


def head_references(x, w_shards, pw, valid, vocab):
    """(tokens, max) of the JAX oracle and of the Pallas kernel
    (interpret mode) on the same inputs."""
    args = (jnp.asarray(x), jnp.asarray(w_shards), jnp.asarray(pw),
            jnp.asarray(valid))
    jt, jm = jref.fused_head_argmax_ref(*args, vocab)
    pt, pm = jdec.cdc_fused_head_argmax_pallas(*args, vocab=vocab,
                                               interpret=True)
    return [(np.asarray(jt), np.asarray(jm)), (np.asarray(pt), np.asarray(pm))]


@pytest.mark.parametrize("b,m_l,k", [(4, 512, 1500), (5, 384, 2100),
                                     (12, 256, 1100)])
def test_head_plan_emulation_matches_reference(b, m_l, k):
    """The split plan adds each split's raw sums in split order, then
    decodes (multiply by the mask), masks ids >= vocab and reduces per
    tile and across tiles: the oracle's and the Pallas kernel's tokens,
    and their max within 1e-4, under every mask with <= 1 dead shard at
    T = 4, on a small card so that k is split, with a vocab that cuts the
    last shard's last tile. The dead shard's weights stay finite: the
    reference removes it by multiply, so a NaN would spread on both
    sides."""
    T = 4
    rng = np.random.default_rng(17)
    x = rng.normal(size=(b, k)).astype(np.float32)
    w_shards = (rng.normal(size=(T, k, m_l)) / np.sqrt(k)).astype(np.float32)
    pw = w_shards.sum(0)
    vocab = T * m_l - 37
    rb, aligned = tdec.head_variant(b, m_l, T * m_l, m_l)
    plan = tdec.head_plan(b, k, m_l, T, 3, 2, aligned)
    assert plan.ksplit > 1 and plan.tiles > 1
    assert (plan.tiles - 1) * plan.bn < m_l - 37   # the cut is in the tile
    for valid in masks(T):
        tok, vmax = emulate_head(plan, x, w_shards, pw, valid, vocab)
        assert np.isfinite(vmax).all()
        for rt, rm in head_references(x, w_shards, pw, valid, vocab):
            np.testing.assert_array_equal(tok, rt, err_msg=f"mask {valid}")
            np.testing.assert_allclose(vmax, rm, err_msg=f"mask {valid}",
                                       **KTOL)


@pytest.mark.parametrize("across", ["tiles", "splits"])
def test_head_plan_emulation_ties_go_to_the_smaller_id(across):
    """A planted tie for the best logit of every row: across two column
    tiles (gid 1 * m_l + 10 in tile 0 against gid 300 in tile 1), or
    across two k splits (one column's weights only in split 0's range, the
    other's only in split 1's, x repeating itself there). Integer-valued
    inputs keep every sum exact in any order, so the tie is exact on every
    side and under every mask: the emulation, the oracle and the Pallas
    kernel all answer the smaller id."""
    T, b, m_l, k = 4, 4, 512, 1500
    rng = np.random.default_rng(23)
    x = rng.integers(1, 3, size=(b, k)).astype(np.float32)
    w_shards = rng.integers(-1, 2, size=(T, k, m_l)).astype(np.float32)
    plan = tdec.head_plan(b, k, m_l, T, 3, 2)
    assert plan.ksplit > 1 and plan.tiles == 2 and plan.bn == 256
    if across == "tiles":
        w_shards[1, :, 10] = w_shards[0, :, 300] = 8.0
        ids = (1 * m_l + 10, 300)
    else:
        kc = plan.kchunk
        x[:, kc:2 * kc] = x[:, :kc]
        w_shards[3, :, 20] = w_shards[2, :, 40] = 0.0
        w_shards[3, :kc, 20] = w_shards[2, kc:2 * kc, 40] = 8.0
        ids = (3 * m_l + 20, 2 * m_l + 40)
    pw = w_shards.sum(0)
    for valid in masks(T):
        tok, vmax = emulate_head(plan, x, w_shards, pw, valid, T * m_l)
        assert tok.tolist() == [min(ids)] * b, (valid, tok)
        for rt, rm in head_references(x, w_shards, pw, valid, T * m_l):
            assert rt.tolist() == [min(ids)] * b, (valid, rt)
            np.testing.assert_array_equal(vmax, rm)


# ------------------------------------------------ kernel 6: RMSNorm ----

@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d", [4096, 12800, 4093, 64, 40000])
def test_rmsnorm_plan_holds_the_row(d, bf16):
    """The register instantiation takes the fewest 16-byte vectors a
    thread that hold the row; a d or stride that is not whole vectors, a
    misaligned base or a row wider than the registers takes the scalar
    one (nv = 0)."""
    e, t = (8 if bf16 else 4), trms.THREADS
    opts = trms.nv_options(bf16)
    assert opts and max(opts) * e <= trms.MAX_VALUES
    nv = trms.rmsnorm_plan(d, d, bf16)
    if d % e or d > opts[-1] * t * e:
        assert nv == 0
    else:
        assert nv in opts and nv * t * e >= d
        assert nv == opts[0] or (nv // 2) * t * e < d
        assert trms.rmsnorm_plan(d, d + 1, bf16) == 0
        assert trms.rmsnorm_plan(d, d, bf16, False) == 0
    assert trms.variant(nv) == ("scalar" if nv == 0 else f"nv{nv}")


def emulate_rmsnorm(x, g, eps, nv):
    """Kernel 6's float32 arithmetic in its order: each thread's sum of
    squares over its values (vector by vector, or 8 strided loads at a
    time in the scalar instantiation), the xor butterfly within each warp,
    then the warps in warp order; out = x * inv * gamma."""
    rows, d = x.shape
    e, tpr = 4, trms.THREADS
    out = np.empty_like(x)
    for r in range(rows):
        xr = x[r]
        th = np.zeros(tpr, np.float32)
        for t in range(tpr):
            if nv:
                idx = [(t + j * tpr) * e + q for j in range(nv)
                       for q in range(e)]
            else:
                idx = list(range(t, d, tpr))
            for i in idx:
                if i < d:
                    th[t] = np.float32(th[t] + xr[i] * xr[i])
        lanes = th.reshape(-1, 32)
        for off in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, np.arange(32) ^ off]
        ss = np.float32(0)
        for w in range(lanes.shape[0]):
            ss = np.float32(ss + lanes[w, 0])
        inv = np.float32(1) / np.sqrt(ss / np.float32(d) + np.float32(eps))
        out[r] = xr * inv * g
    return out


@pytest.mark.parametrize("d", [4096, 12800, 4093])
def test_rmsnorm_emulation_matches_reference(d):
    """Kernel 6's reduction order against the Pallas kernel in interpret
    mode and the torch oracle, at 1e-5 (float32 rounding only)."""
    rng = np.random.default_rng(29)
    x = (3.0 * rng.normal(size=(4, d))).astype(np.float32)
    g = (1.0 + 0.1 * rng.normal(size=d)).astype(np.float32)
    nv = trms.rmsnorm_plan(d, d, False)
    assert (nv == 0) == (d % 4 != 0)
    got = emulate_rmsnorm(x, g, 1e-5, nv)
    want = np.asarray(jrms.rmsnorm_pallas(jnp.asarray(x), jnp.asarray(g),
                                          eps=1e-5, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, tref.rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(g),
                              1e-5).numpy(), rtol=1e-5, atol=1e-5)


# ------------------------------------- T = 16 and bf16 (kernels 1, 2) ----

@pytest.mark.parametrize("rows", [1, 4, 5, 8, 16, 64])
@pytest.mark.parametrize("layout", ["folded", "dedicated"])
@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_coded_plan_covers_granite_shapes_t16(r, layout, rows):
    """Kernel 1 at T = 16 (17-20 streams): no 16-row blocks (their
    epilogue holds 12 streams), tiles narrowed to 128 columns where a
    256-column stage would hold one k row, and granite's folded w1 (slices
    of 50 columns, half a 16-byte vector off) on the copy engine with box
    rows one vector wider than the tile where the parity's rows (r x 50
    columns) are whole vectors (r = 2, 4), else on the row copies."""
    T, k = 16, 4096
    for width in GRANITE_WIDTHS:
        m_l = width // T
        plan = tcdc.coded_plan(rows, k, m_l, T, r, layout, N_SM, OCC)
        wd = m_l // T if layout == "folded" else m_l
        pstride = r * wd if layout == "folded" else m_l
        assert plan.rb == (4 if rows <= 4 else 8)
        assert plan.aligned == (pstride % 4 == 0)
        assert plan.lead == (4 if not plan.aligned or wd % 4 else 0)
        assert plan.bn <= 128 and plan.ks >= 2
        check_limits(plan, T + r)
        check_cover(plan, rows, k, m_l, wd if layout == "folded" else None)
        assert plan.blocks == len(plan.units())


@pytest.mark.parametrize("layout", ["folded", "dedicated"])
@pytest.mark.parametrize("T,r", [(2, 1), (4, 2), (4, 4), (8, 4), (16, 2)])
def test_coded_plan_bf16_counts_bytes(T, r, layout):
    """On bf16 weights a 32 KB stage holds twice the k rows of a float32
    one, and the copy engine needs row strides of whole 16-byte vectors of
    2-byte elements and m_l and the slice width in whole 8-byte halves (a
    box row then starts half a vector before its tile)."""
    k = 4096
    for width in GRANITE_WIDTHS:
        m_l = width // T
        wd = m_l // T if layout == "folded" else m_l
        f32 = tcdc.coded_plan(4, k, m_l, T, r, layout, N_SM, 1)
        bf = tcdc.coded_plan(4, k, m_l, T, r, layout, N_SM, 1, elem=2)
        pstride = r * wd if layout == "folded" else m_l
        assert bf.elem == 2 and bf.variant.endswith("-bf16")
        assert bf.aligned == (pstride % 8 == 0 and T * m_l % 8 == 0
                              and m_l % 4 == 0 and wd % 4 == 0)
        assert bf.lead == (8 if not bf.aligned or m_l % 8 or wd % 8 else 0)
        if bf.bn == f32.bn and bf.aligned and f32.aligned:
            cap = stream_plan.stage_rows(T + r, bf.pitch, 2)
            assert cap >= 2 * stream_plan.stage_rows(T + r, f32.pitch) - 1
        check_limits(bf, T + r)
        check_cover(bf, 4, k, m_l, wd if layout == "folded" else None)
    assert not tcdc.coded_plan(4, k, 1024, 4, 2, "folded", N_SM, 1,
                               ldw=4 * 1024 + 4, elem=2).aligned


@pytest.mark.parametrize("rows", [1, 4, 9, 17])
@pytest.mark.parametrize("T,elem", [(4, 2), (16, 4), (16, 2)])
def test_head_plan_t16_and_bf16(T, elem, rows):
    """Kernel 2 at T = 16 (17 streams: 4- and 8-row blocks) and on bf16
    weights: granite's bf16 head at T = 4 (m_l = 12292, no whole 16-byte
    vectors) takes the copy engine through its 2-D map once its parity
    lives in rows of whole vectors (``head_parity``), and the row
    copies with a contiguous parity."""
    k, m_l = 4096, head_width(T)
    rb, aligned = tdec.head_variant(rows, m_l, T * m_l, m_l, True, T, elem,
                                    -(-m_l // 8) * 8)
    assert aligned
    assert rb == (4 if rows <= 4 else 8 if rows <= 8 or T == 16 else 16)
    plan = tdec.head_plan(rows, k, m_l, T, N_SM, card_occupancy(rb),
                          aligned, elem)
    check_limits(plan, T + 1)
    check_cover(plan, rows, k, m_l)
    lead = tdec.head_lead(T * m_l, m_l, aligned, elem)
    assert lead == (8 if elem == 2 and m_l % 8 else 0)
    wide = tdec.head_plan(rows, k, m_l, T, N_SM, card_occupancy(rb),
                          aligned, elem, lead)
    assert wide.lead == lead and wide.pitch <= 256
    check_limits(wide, T + 1)
    check_cover(wide, rows, k, m_l)
    if elem == 2 and m_l % 8:
        assert not tdec.head_variant(rows, m_l, T * m_l, m_l, True, T,
                                     elem)[1]
    w = torch.zeros((T, 8, m_l), dtype=torch.bfloat16 if elem == 2
                    else torch.float32)
    pw = tdec.head_parity(w)
    assert pw.shape == (8, m_l) and pw.stride(0) * elem % 16 == 0


@pytest.mark.parametrize("elem,gap,aligned,lead", [
    (4, 4, True, 0), (4, 8, True, 0), (4, 2, False, 0),
    (2, 4, True, 8), (2, 8, True, 0), (2, 2, False, 0),
    (4, None, True, 0), (2, None, True, 0)])
def test_head_shards_apart_or_stacked(elem, gap, aligned, lead):
    """Kernel 2's copy engine at any shard offset: column shards ``gap``
    columns apart go through the one 2-D map when the offset is whole
    float32 vectors (box rows a vector wider where a bf16 offset is half
    a 16-byte vector off), shards stored one after another (gap None)
    through the 3-D map; the parity is contiguous."""
    T, k, m_l = 4, 4096, 2048
    ldw, sstr = (m_l, k * m_l) if gap is None else (T * (m_l + gap),
                                                     m_l + gap)
    rb, ok = tdec.head_variant(4, m_l, ldw, sstr, True, T, elem)
    assert (rb, ok) == (4, aligned)
    assert tdec.head_lead(ldw, sstr, ok, elem) == lead
    plan = tdec.head_plan(4, k, m_l, T, N_SM, card_occupancy(rb), ok, elem,
                          lead)
    assert plan.variant == f"rb4-{'async' if ok else 'rowcopy'}" + (
        "-lead" if lead else "") + ("-bf16" if elem == 2 else "")
    check_limits(plan, T + 1)
    check_cover(plan, 4, k, m_l)


def test_t16_plan_emulations_split_k():
    """The small T = 16 shapes below (k = 128) split k on a small card
    where the tile is wide enough for short stages."""
    assert tcdc.coded_plan(5, 128, 64, 16, 2, "dedicated", 3, 2).ksplit > 1
    assert tdec.head_plan(4, 128, 64, 16, 3, 2).ksplit > 1


@pytest.mark.parametrize("layout", ["folded", "dedicated"])
@pytest.mark.parametrize("r", [1, 2])
def test_coded_plan_emulation_t16_matches_reference(r, layout):
    """Kernel 1's split plan at T = 16 (k = 128, m_l = 64, 5 rows, a small
    card) emulated on the CPU: equal to the reference oracle and its
    Pallas kernel (interpret) within 1e-5 under the all-valid mask and
    every single dead shard, the dead shard's weights (and, folded, its
    parity slot) NaN. Folded r = 1 tolerates no device failure (the dead
    device holds a slice's only parity), so there the shard's output is
    erased and the parity slots stay readable (a message erasure)."""
    T, rows, k, m_l = 16, 5, 128, 64
    rng = np.random.default_rng(31 + r)
    x = rng.normal(size=(rows, k)).astype(np.float32)
    w = (rng.normal(size=(k, T * m_l)) / np.sqrt(k)).astype(np.float32)
    jspec = jcl.CodedDenseSpec(jcoding.CodeSpec(T, r), layout=layout)
    tspec = tcl.CodedDenseSpec(tcoding.CodeSpec(T, r), layout=layout)
    wc = np.asarray(jcl.make_parity_weights(jnp.asarray(w), jspec))
    plan = tcdc.coded_plan(rows, k, m_l, T, r, layout, 3, 2)
    gen = np.asarray(jcoding.generator_matrix(T, r), np.float32)
    w_sh = jnp.asarray(w).reshape(k, T, m_l).transpose(1, 0, 2)
    pw = jnp.asarray(wc) if layout == "dedicated" else \
        jcl.unfold_parity(jnp.asarray(wc), T, r)
    device = not (layout == "folded" and r == 1)
    for valid in masks(T):
        vp = valid if device else (True,) * T
        wn, wcn = w.copy(), wc.copy()
        for d in range(T):
            if not valid[d]:
                wn[:, d * m_l:(d + 1) * m_l] = np.nan
                if layout == "folded" and device:
                    wcn[d] = np.nan
        te, tc = tcdc.eq12_plan(tspec, torch.tensor(valid),
                                torch.tensor(vp), m_l)
        got = emulate_coded(plan, x, wn, wcn, layout, T, r, gen,
                            te.numpy(), tc.numpy(), valid)
        assert np.isfinite(got).all(), f"NaN spread (mask {valid})"
        je, jc = jcdc.eq12_plan(jspec, jnp.asarray(valid), jnp.asarray(vp),
                                m_l)
        args = (jnp.asarray(x), w_sh, pw, jnp.asarray(gen), je, jc,
                jnp.asarray(valid))
        np.testing.assert_allclose(
            got, np.asarray(jref.cdc_coded_matmul_ref(*args)),
            err_msg=f"mask {valid}", rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            got, np.asarray(jcdc.cdc_coded_matmul_pallas(*args,
                                                         interpret=True)),
            err_msg=f"mask {valid}", rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b", [4, 9])
def test_head_plan_emulation_t16_matches_reference(b):
    """Kernel 2's split plan at T = 16 (k = 128, m_l = 64, a small card)
    emulated on the CPU: the oracle's and the Pallas kernel's tokens, and
    their max within 1e-5, under every mask with <= 1 dead shard, with a
    vocab that cuts the last shard."""
    T, k, m_l = 16, 128, 64
    rng = np.random.default_rng(37 + b)
    x = rng.normal(size=(b, k)).astype(np.float32)
    w_shards = (rng.normal(size=(T, k, m_l)) / np.sqrt(k)).astype(np.float32)
    pw = w_shards.sum(0)
    vocab = T * m_l - 11
    plan = tdec.head_plan(b, k, m_l, T, 3, 2)
    for valid in masks(T):
        tok, vmax = emulate_head(plan, x, w_shards, pw, valid, vocab)
        for rt, rm in head_references(x, w_shards, pw, valid, vocab):
            np.testing.assert_array_equal(tok, rt, err_msg=f"mask {valid}")
            np.testing.assert_allclose(vmax, rm, err_msg=f"mask {valid}",
                                       rtol=1e-5, atol=1e-5)
