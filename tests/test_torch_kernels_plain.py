"""The port's kernel layer on the CPU: the plain versions of the two CUDA
kernels, the Eq. 12 decode plan and the dispatch ladder, against the
reference package on the same numpy inputs.

Tolerances: the plain versions repeat the reference oracles' float32
arithmetic, so they agree to 1e-5 (1e-4 for a solve for 2+ dead shards
at r >= 3, whose conditioning amplifies rounding; see
tests/test_torch_coding.py); against the reference's Pallas kernels
(run in interpret mode, as the reference's own tests run them) 1e-4, the
reference's own kernel-vs-reference bound (TOL in
tests/test_kernels_conformance.py).
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
from repro_torch.core import coded_layer as tcl
from repro_torch.core import coding as tcoding
from repro_torch.kernels import cdc_decode, cdc_matmul as tcdc
from repro_torch.kernels import cdc_encode as tenc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(rtol=1e-5, atol=1e-5)
KTOL = dict(rtol=1e-4, atol=1e-4)
CASES = [(T, r, layout)
         for T, r in ((2, 1), (2, 2), (4, 1), (4, 2), (4, 3), (4, 4))
         for layout in ("folded", "dedicated")]


def masks(T, budget):
    out = [(True,) * T]
    for f in range(1, budget + 1):
        for dead in itertools.combinations(range(T), f):
            out.append(tuple(i not in dead for i in range(T)))
    return out


def specs(T, r, layout):
    return (jcl.CodedDenseSpec(jcoding.CodeSpec(T, r), layout=layout),
            tcl.CodedDenseSpec(tcoding.CodeSpec(T, r), layout=layout))


def case(T, r, layout, *, rows=5, k=24, m=None, seed=0):
    jspec, tspec = specs(T, r, layout)
    m = m or (T * T * 2 if layout == "folded" else T * 7)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, k)).astype(np.float32)
    w = (rng.normal(size=(k, m)) / np.sqrt(k)).astype(np.float32)
    jp = np.asarray(jcl.make_parity_weights(jnp.asarray(w), jspec))
    return jspec, tspec, x, w, jp


def close(t, j, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), err_msg=msg,
                               **tol)


@pytest.mark.parametrize("T,r,layout", CASES)
def test_eq12_plan_matches_reference(T, r, layout):
    jspec, tspec = specs(T, r, layout)
    for m_l in (2 * T, 3 * T, 7):
        for mask in masks(T, 1):
            for pmask in (mask, (True,) * T):      # device / message erasure
                je, jc = jcdc.eq12_plan(jspec, jnp.asarray(mask),
                                        jnp.asarray(pmask), m_l)
                te, tc = tcdc.eq12_plan(tspec, torch.tensor(mask),
                                        torch.tensor(pmask), m_l)
                np.testing.assert_array_equal(te.numpy(), np.asarray(je))
                assert te.dtype == torch.int32 and tc.dtype == torch.float32
                close(tc.numpy(), jc)


@pytest.mark.parametrize("T,r,layout", CASES)
def test_coded_matmul_plain_matches_reference_oracle(T, r, layout):
    """The plain version of kernel 1 (as its wrapper runs it on a CPU
    tensor: parity read in its stored layout) == the reference oracle."""
    jspec, tspec, x, w, jp = case(T, r, layout)
    k, m = w.shape
    m_l = m // T
    w_st = np.moveaxis(w.reshape(k, T, m_l), 1, 0)
    pw = jp if layout == "dedicated" else \
        np.asarray(jcl.unfold_parity(jnp.asarray(jp), T, r))
    gamma = (1 + 0.1 * np.random.default_rng(9).normal(size=k)) \
        .astype(np.float32)
    for mask in masks(T, 1):
        je, jc = jcdc.eq12_plan(jspec, jnp.asarray(mask), jnp.asarray(mask),
                                m_l)
        te, tc = tcdc.eq12_plan(tspec, torch.tensor(mask),
                                torch.tensor(mask), m_l)
        gen = tcoding.generator_tensor(tspec.code)
        for g in (None, gamma):
            j = jref.cdc_coded_matmul_ref(
                jnp.asarray(x), jnp.asarray(w_st), jnp.asarray(pw),
                jnp.asarray(jspec.code.generator, jnp.float32), je, jc,
                jnp.asarray(mask), gamma=None if g is None else
                jnp.asarray(g))
            t = tcdc.cdc_coded_matmul(
                torch.from_numpy(x), torch.from_numpy(w),
                torch.from_numpy(jp.copy()), layout, T, r, gen, te, tc, mask,
                gamma=None if g is None else torch.from_numpy(g))
            assert t.shape == (x.shape[0], T, m_l)
            close(t, j, msg=f"{layout} T={T} r={r} mask={mask} "
                            f"gamma={g is not None}")


@pytest.mark.parametrize("T,r,layout", CASES)
def test_fused_coded_matmul_matches_reference_ops(T, r, layout):
    """ops.fused_coded_matmul on the CPU == the reference's, both its
    oracle and its Pallas kernel in interpret mode, under every in-budget
    mask (2-dead masks take the reference path on both sides)."""
    jspec, tspec, x, w, jp = case(T, r, layout, rows=4)
    x3 = x.reshape(2, 2, -1)
    tp = tcl.make_parity_weights(torch.from_numpy(w), tspec)
    for mask in masks(T, jspec.max_device_failures):
        v = jnp.asarray(mask)
        t = tops.fused_coded_matmul(torch.from_numpy(x3),
                                    torch.from_numpy(w), tp, tspec,
                                    np.array(mask))
        oracle = jops.fused_coded_matmul(jnp.asarray(x3), jnp.asarray(w),
                                         jnp.asarray(jp), jspec, v,
                                         use_pallas=False)
        close(t, oracle, KTOL if r >= 3 and T - sum(mask) >= 2 else TOL,
              msg=f"{layout} T={T} r={r} mask={mask}")
        if sum(mask) >= T - 1 and T == 4 and r == 2:
            pallas = jops.fused_coded_matmul(jnp.asarray(x3),
                                             jnp.asarray(w), jnp.asarray(jp),
                                             jspec, v)
            close(t, pallas, KTOL, msg=f"pallas-interpret mask={mask}")


@pytest.mark.parametrize("r", [3, 4])
def test_fused_coded_matmul_t8_matches_reference_pallas(r):
    """T=8 folded at r = 3 and 4 (the planner's r=4 at T=8, kernel 1's
    (8, 3) and (8, 4) cases): ops.fused_coded_matmul on the CPU == the
    reference's Pallas kernel (interpret) under every mask with <= 1 dead,
    within 1e-4."""
    T = 8
    jspec, tspec, x, w, jp = case(T, r, "folded", rows=4)
    tp = tcl.make_parity_weights(torch.from_numpy(w), tspec)
    close(tp, jp)
    for mask in masks(T, 1):
        t = tops.fused_coded_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                    tp, tspec, np.array(mask))
        pallas = jops.fused_coded_matmul(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(jp), jspec,
                                         jnp.asarray(mask))
        close(t, pallas, KTOL, msg=f"(8, {r}) folded mask={mask}")


@pytest.mark.parametrize("T", [2, 4])
def test_fused_head_plain_matches_reference(T):
    rng = np.random.default_rng(5)
    k, m_l, b = 32, 37, 3
    vocab = T * m_l - 5
    x = rng.normal(size=(b, k)).astype(np.float32)
    w = rng.normal(size=(T, k, m_l)).astype(np.float32)
    pw = w.sum(0)
    for mask in masks(T, 1):
        jt, jm = jref.fused_head_argmax_ref(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(pw),
                                            jnp.asarray(mask), vocab)
        tt, tm = tops.fused_head_argmax(torch.from_numpy(x),
                                        torch.from_numpy(w),
                                        torch.from_numpy(pw),
                                        np.array(mask), vocab=vocab)
        assert tt.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        close(tm, jm)
        if T == 4:
            pt, pm = jops.fused_head_argmax(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(pw),
                                            jnp.asarray(mask), vocab=vocab)
            np.testing.assert_array_equal(tt.numpy(), np.asarray(pt))
            close(tm, pm, KTOL)


def test_fused_head_ties_go_to_smallest_id():
    """Equal logits in two shards: both packages pick the smaller id."""
    T, k, m_l = 4, 8, 6
    rng = np.random.default_rng(6)
    x = np.abs(rng.normal(size=(2, k))).astype(np.float32)
    w = rng.normal(size=(T, k, m_l)).astype(np.float32) * 0.01
    w[2, :, 1] = 1.0                 # gid 13
    w[1, :, 4] = 1.0                 # gid 10: the same logit, smaller id
    pw = w.sum(0)
    mask = (True,) * T
    tt, _ = tops.fused_head_argmax(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(pw), np.array(mask),
                                   vocab=T * m_l)
    jt, _ = jref.fused_head_argmax_ref(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(pw), jnp.asarray(mask),
                                       T * m_l)
    assert tt.tolist() == [10, 10] == np.asarray(jt).tolist()


def test_plain_helpers_match_reference():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 16)).astype(np.float32)
    g = rng.normal(size=16).astype(np.float32)
    close(tref.rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(g), 1e-5),
          jref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(g), 1e-5))
    T, r, m_l = 4, 2, 8
    y = rng.normal(size=(T, 3, m_l)).astype(np.float32)
    p = rng.normal(size=(r, 3, m_l)).astype(np.float32)
    gen = jcoding.generator_matrix(T, r).astype(np.float32)
    mask = (True, False, True, True)
    spec = jcl.CodedDenseSpec(jcoding.CodeSpec(T, r))
    je, jc = jcdc.eq12_plan(spec, jnp.asarray(mask), jnp.asarray(mask), m_l)
    j = jref._eq12_combine_ref(jnp.asarray(y), jnp.asarray(p),
                               jnp.asarray(gen), jnp.asarray(mask), je, jc)
    t = tref._eq12_combine_ref(torch.from_numpy(y), torch.from_numpy(p),
                               torch.from_numpy(gen), torch.tensor(mask),
                               torch.from_numpy(np.array(je)),
                               torch.from_numpy(np.array(jc)))
    close(t, j)


def test_dispatch_ladder():
    """Fallbacks and refusals exactly where the reference ops take them."""
    T, r = 4, 2
    jspec, tspec, x, w, jp = case(T, r, "dedicated")
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    tp = torch.from_numpy(jp.copy())
    # 2 dead (in budget for dedicated r=2): the reference path verbatim
    two_dead = np.array([True, False, True, False])
    np.testing.assert_array_equal(
        tops.fused_coded_matmul(xt, wt, tp, tspec, two_dead).numpy(),
        tcl.coded_matmul(xt, wt, tp, tspec, two_dead).numpy())
    # no parity / no mask: the plain merged product
    for wc, v in ((None, np.ones(T, bool)), (tp, None)):
        np.testing.assert_array_equal(
            tops.fused_coded_matmul(xt, wt, wc, tspec, v).numpy(),
            tcl.coded_matmul(xt, wt, wc, tspec, v).numpy())
    # the fused head refuses 2+ dead, as the reference does
    ws = torch.from_numpy(np.moveaxis(w.reshape(-1, T, w.shape[1] // T),
                                      1, 0).copy())
    with pytest.raises(ValueError, match="at most 1 erased"):
        tops.fused_head_argmax(xt, ws, ws.sum(0), two_dead, vocab=8)
    with pytest.raises(ValueError, match="at most 1 erased"):
        jops.fused_head_argmax(jnp.asarray(x), jnp.asarray(ws.numpy()),
                               jnp.asarray(ws.sum(0).numpy()),
                               jnp.asarray(two_dead), vocab=8,
                               use_pallas=False)
    # a meta tensor (the dry run's: shapes, no storage) takes the plain
    # version, as a CPU tensor does: a meta result of the CPU result's
    # shape and dtype, nothing computed or launched
    one_dead = np.array([True, False, True, True])
    for got, want in (
            (tops.fused_coded_matmul(xt.to("meta"), wt.to("meta"),
                                     tp.to("meta"), tspec, one_dead),
             tops.fused_coded_matmul(xt, wt, tp, tspec, one_dead)),
            *zip(tops.fused_head_argmax(xt.to("meta"), ws.to("meta"),
                                        ws.sum(0).to("meta"), one_dead,
                                        vocab=8),
                 tops.fused_head_argmax(xt, ws, ws.sum(0), one_dead,
                                        vocab=8))):
        assert got.is_meta and got.shape == want.shape
        assert got.dtype == want.dtype


def test_dead_shard_nan_does_not_spread():
    """Kernel 1's plain version zeroes a dead shard by select: NaNs in the
    dead shard's weights leave the recovered output finite and exact."""
    T, r = 4, 2
    _, tspec, x, w, _ = case(T, r, "folded", m=T * T * 2)
    m_l = w.shape[1] // T
    clean = tops.fused_coded_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                    tcl.make_parity_weights(
                                        torch.from_numpy(w), tspec),
                                    tspec, np.ones(T, bool))
    for d in range(T):
        wn = w.copy()
        wn[:, d * m_l:(d + 1) * m_l] = np.nan
        # parity from the healthy weights; the dead shard's own folded
        # parity slices are unreadable too
        wc = tcl.make_parity_weights(torch.from_numpy(w), tspec)
        wc[d] = float("nan")
        mask = np.array([i != d for i in range(T)])
        out = tops.fused_coded_matmul(torch.from_numpy(x),
                                      torch.from_numpy(wn), wc, tspec, mask)
        assert torch.isfinite(out).all(), f"NaN spread from dead shard {d}"
        close(out, clean.numpy(), KTOL)


def test_split_k_covers_the_contraction():
    """Kernel 1's launch plan (which replaced split_k) splits k into
    in-order ranges that cover [0, k) once."""
    for rows, k, m_l in ((1, 4096, 256), (4, 4096, 1024), (16, 4096, 3200),
                         (4, 24, 7), (8, 100, 33)):
        plan = tcdc.coded_plan(rows, k, m_l, 4, 2, "dedicated", 132, 2)
        assert plan.ksplit >= 1 and plan.kchunk >= 1
        assert (plan.ksplit - 1) * plan.kchunk < k <= plan.ksplit * plan.kchunk


def test_kernel_cost_models_match_reference():
    out = [("float32", [4, 4, 256])]
    ops_in = [("bool", [4]), ("int32", [256]), ("float32", [256]),
              ("float32", [2, 4]), ("float32", [4, 4096]),
              ("float32", [4, 4096, 256]), ("float32", [2, 4096, 256])]
    assert tops.KERNEL_COSTS["cdc_coded_matmul"](out, ops_in) == \
        jops.KERNEL_COSTS["cdc_coded_matmul_pallas"](out, ops_in)
    out = [("float32", [4, 1]), ("int32", [4, 1])]
    ops_in = [("bool", [4]), ("float32", [4, 4096]),
              ("float32", [4, 4096, 12292]), ("float32", [4096, 12292])]
    assert tops.KERNEL_COSTS["cdc_fused_head_argmax"](out, ops_in) == \
        jops.KERNEL_COSTS["cdc_fused_head_argmax_pallas"](out, ops_in)


# ------------------------------------------------------ parity encode ----

ETOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T,r", [(T, r) for T in (2, 4)
                                 for r in range(1, T + 1)])
def test_encode_plain_matches_reference_kernel(T, r):
    """ref.cdc_encode_ref and ops.cdc_encode on CPU tensors == the
    reference's ops.cdc_encode (its Pallas kernel in interpret mode) at
    the Pallas blocks, k = m_l = 256, within 1e-6; a stacked [L, T, k,
    m_l] input encodes every layer in one call."""
    rng = np.random.default_rng(10 + 8 * T + r)
    w = rng.normal(size=(T, 256, 256)).astype(np.float32)
    gen = jcoding.generator_matrix(T, r)
    want = np.asarray(jops.cdc_encode(jnp.asarray(w), gen))
    g32 = torch.from_numpy(gen.astype(np.float32))
    close(tref.cdc_encode_ref(torch.from_numpy(w), g32), want, ETOL)
    close(tops.cdc_encode(torch.from_numpy(w), gen), want, ETOL)
    stacked = tops.cdc_encode(torch.from_numpy(np.stack([w, -w])), gen)
    assert stacked.shape == (2, r, 256, 256)
    close(stacked[1], -want, ETOL)


@pytest.mark.parametrize("T,r,layout", [(2, 2, "folded")] + [
    (4, r, layout) for r in (1, 2, 3, 4)
    for layout in ("folded", "dedicated")])
def test_encode_layouts_match_reference_parity_weights(T, r, layout):
    """Ragged shapes (k = 37, m_l = 5 T) in both layouts: the port's
    make_parity_weights (through ops.cdc_encode) equals the reference's,
    for one layer and stacked, and ops.cdc_encode reads the shards as a
    strided view of the raw weight."""
    jspec, tspec = specs(T, r, layout)
    rng = np.random.default_rng(20 + r)
    w = rng.normal(size=(37, T * T * 5)).astype(np.float32)
    want = np.asarray(jcl.make_parity_weights(jnp.asarray(w), jspec))
    got = tcl.make_parity_weights(torch.from_numpy(w), tspec)
    close(got, want)
    view = torch.from_numpy(w).reshape(37, T, -1).permute(1, 0, 2)
    assert not view.is_contiguous()
    close(tops.cdc_encode(view, tspec.code.generator, layout=layout), want)
    w3 = np.stack([w, 2 * w])
    close(tcl.make_parity_weights(torch.from_numpy(w3), tspec),
          jcl.make_parity_weights(jnp.asarray(w3), jspec))


def test_encode_folded_write_at_t12_w1_slices_matches_reference():
    """T = 12, r = 2 at granite's w1 shard width (m_l 1068: folded slices
    of 89 columns), k = 16: the port's plain folded write
    (make_parity_weights through ops.cdc_encode) equals the reference's
    make_parity_weights within 1e-5, and so does the kernel's write from
    16-byte reads (csrc/cdc_encode.cu), emulated here: each vector of 4
    columns c .. c + 3, column c + e of parity j to slot (s + j + 1) % T
    at offset j * wd + o, (s, o) stepping from (c // wd, c % wd) one
    column at a time."""
    T, r, m_l, k = 12, 2, 1068, 16
    jspec, tspec = specs(T, r, "folded")
    w = np.random.default_rng(12).normal(size=(k, T * m_l)).astype(
        np.float32)
    want = np.asarray(jcl.make_parity_weights(jnp.asarray(w), jspec))
    close(tcl.make_parity_weights(torch.from_numpy(w), tspec), want)
    parity = tref.cdc_encode_ref(
        torch.from_numpy(w).reshape(k, T, m_l).permute(1, 0, 2),
        torch.from_numpy(tspec.code.generator.astype(np.float32))).numpy()
    wd = m_l // T
    out = np.full((T, k, r * wd), np.nan, np.float32)
    for c in range(0, m_l, 4):
        for j in range(r):
            s, o = c // wd, c % wd
            for e in range(4):
                out[(s + j + 1) % T, :, j * wd + o] = parity[j, :, c + e]
                o += 1
                if o == wd:
                    s, o = s + 1, 0
    close(torch.from_numpy(out), want)


def test_encode_refuses_what_it_cannot_run():
    T, r = 4, 2
    gen = jcoding.generator_matrix(T, r)
    w = torch.zeros((T, 8, 8))
    # a meta tensor takes the plain version (the dry run's encode)
    meta = tops.cdc_encode(w.to("meta"), gen)
    assert meta.is_meta and meta.shape == tops.cdc_encode(w, gen).shape
    with pytest.raises(ValueError, match="unknown layout"):
        tops.cdc_encode(w, gen, layout="striped")
    with pytest.raises(ValueError, match="not divisible"):
        tcl.make_parity_weights(torch.zeros((8, 10)),
                                tcl.CodedDenseSpec(tcoding.CodeSpec(T, r)))


def test_encode_cost_model_matches_reference():
    out = [("float32", [2, 4096, 3200])]
    ops_in = [("float32", [2, 4]), ("float32", [4, 4096, 3200])]
    assert tops.KERNEL_COSTS["cdc_encode"](out, ops_in) == \
        jops.KERNEL_COSTS["cdc_encode_pallas"](out, ops_in)


# ----------------------------------------------- T = 16 and bf16 storage ----

BTOL = dict(rtol=2e-2, atol=2e-2)   # the reference's bf16 oracle bound


def single_masks(T):
    """The all-valid mask and every single dead shard: the kernels'
    regime."""
    return masks(T, 1)


@pytest.mark.parametrize("layout", ["folded", "dedicated"])
@pytest.mark.parametrize("r", [1, 2])
def test_coded_matmul_plain_t16_matches_reference_pallas(r, layout):
    """Kernel 1's plain version (its wrapper on CPU tensors) at T = 16 ==
    the reference's Pallas kernel in interpret mode within 1e-5, under the
    all-valid mask and every single dead shard (k = 128, m_l = 32)."""
    T, rows, k, m_l = 16, 3, 128, 32
    jspec, tspec = specs(T, r, layout)
    rng = np.random.default_rng(40 + r)
    x = rng.normal(size=(rows, k)).astype(np.float32)
    w = (rng.normal(size=(k, T * m_l)) / np.sqrt(k)).astype(np.float32)
    jp = np.asarray(jcl.make_parity_weights(jnp.asarray(w), jspec))
    w_st = jnp.asarray(w).reshape(k, T, m_l).transpose(1, 0, 2)
    pw = jnp.asarray(jp) if layout == "dedicated" else \
        jcl.unfold_parity(jnp.asarray(jp), T, r)
    gen = tcoding.generator_tensor(tspec.code)
    for mask in single_masks(T):
        te, tc = tcdc.eq12_plan(tspec, torch.tensor(mask),
                                torch.tensor(mask), m_l)
        t = tcdc.cdc_coded_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(jp.copy()), layout, T, r,
                                  gen, te, tc, mask)
        je, jc = jcdc.eq12_plan(jspec, jnp.asarray(mask), jnp.asarray(mask),
                                m_l)
        j = jcdc.cdc_coded_matmul_pallas(
            jnp.asarray(x), w_st, pw, jnp.asarray(gen.numpy()), je, jc,
            jnp.asarray(mask), interpret=True)
        close(t, j, msg=f"(16, {r}) {layout} mask={mask}")


def test_fused_head_plain_t16_matches_reference_pallas():
    """Kernel 2's plain version at T = 16 == the reference's Pallas kernel
    in interpret mode: equal tokens, max within 1e-5, every mask with <= 1
    dead shard, a vocab that cuts the last shard."""
    T, k, m_l, b = 16, 64, 24, 3
    rng = np.random.default_rng(44)
    x = rng.normal(size=(b, k)).astype(np.float32)
    w = rng.normal(size=(T, k, m_l)).astype(np.float32)
    pw = w.sum(0)
    vocab = T * m_l - 5
    for mask in single_masks(T):
        tt, tm = cdc_decode.cdc_fused_head_argmax(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(pw),
            mask, vocab=vocab)
        pt, pm = jdec.cdc_fused_head_argmax_pallas(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(pw),
            jnp.asarray(mask), vocab=vocab, interpret=True)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(pt))
        close(tm, pm, msg=f"mask {mask}")


@pytest.mark.parametrize("T,r,layout", [(4, 2, "folded"), (4, 1, "dedicated"),
                                        (16, 2, "folded")])
def test_coded_matmul_plain_bf16_matches_reference_pallas(T, r, layout):
    """Kernel 1's plain version on bf16 x, weights and parity == the
    reference's Pallas kernel in interpret mode on the same bf16 values,
    within 2e-2, and its output dtype is the reference's (x's: bf16)."""
    rows, k = 4, 128
    m_l = 2 * T if layout == "folded" else 24
    jspec, tspec = specs(T, r, layout)
    rng = np.random.default_rng(50 + T + r)
    x = rng.normal(size=(rows, k)).astype(np.float32)
    w = (rng.normal(size=(k, T * m_l)) / np.sqrt(k)).astype(np.float32)
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    jp = jcl.make_parity_weights(jw, jspec)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    tp = tcl.make_parity_weights(tw, tspec)
    assert tp.dtype == torch.bfloat16 and jp.dtype == jnp.bfloat16
    gen = tcoding.generator_tensor(tspec.code)
    pw = jp if layout == "dedicated" else jcl.unfold_parity(jp, T, r)
    for mask in single_masks(T):
        te, tc = tcdc.eq12_plan(tspec, torch.tensor(mask),
                                torch.tensor(mask), m_l)
        t = tcdc.cdc_coded_matmul(torch.from_numpy(x).to(torch.bfloat16), tw,
                                  tp, layout, T, r, gen, te, tc, mask)
        je, jc = jcdc.eq12_plan(jspec, jnp.asarray(mask), jnp.asarray(mask),
                                m_l)
        j = jcdc.cdc_coded_matmul_pallas(
            jnp.asarray(x).astype(jnp.bfloat16),
            jw.reshape(k, T, m_l).transpose(1, 0, 2), pw,
            jnp.asarray(gen.numpy()), je, jc, jnp.asarray(mask),
            interpret=True)
        assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        close(t.float(), np.asarray(j.astype(jnp.float32)), BTOL,
              msg=f"bf16 ({T}, {r}) {layout} mask={mask}")


@pytest.mark.parametrize("x_bf16", [False, True])
def test_fused_head_plain_bf16_matches_reference_pallas(x_bf16):
    """Kernel 2's plain version on bf16 head weights (float32 x as the
    serving round gives it, or bf16 x) == the reference's Pallas kernel in
    interpret mode: equal tokens, max within 2e-2, int32 token and float32
    max as the reference returns them."""
    T, k, m_l, b = 4, 64, 40, 3
    rng = np.random.default_rng(46)
    x = rng.normal(size=(b, k)).astype(np.float32)
    w = rng.normal(size=(T, k, m_l)).astype(np.float32)
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    jx = jnp.asarray(x).astype(jnp.bfloat16) if x_bf16 else jnp.asarray(x)
    tx = torch.from_numpy(x).to(torch.bfloat16) if x_bf16 else \
        torch.from_numpy(x)
    vocab = T * m_l - 3
    for mask in single_masks(T):
        tt, tm = cdc_decode.cdc_fused_head_argmax(
            tx, tw, cdc_decode.head_parity(tw), mask, vocab=vocab)
        pt, pm = jdec.cdc_fused_head_argmax_pallas(
            jx, jw, jw.sum(0), jnp.asarray(mask), vocab=vocab,
            interpret=True)
        assert tt.dtype == torch.int32 and pt.dtype == jnp.int32
        assert tm.dtype == torch.float32 and pm.dtype == jnp.float32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(pt))
        close(tm, pm, BTOL, msg=f"mask {mask}")


@pytest.mark.parametrize("T,r", [(4, 2), (16, 2)])
def test_encode_plain_bf16_matches_reference_kernel(T, r):
    """Kernel 4's plain version on bf16 shards == the reference's Pallas
    encode in interpret mode within 2e-2, with bf16 parity as the
    reference returns it."""
    rng = np.random.default_rng(48 + T)
    w = rng.normal(size=(T, 128, 64)).astype(np.float32)
    gen = jcoding.generator_matrix(T, r)
    want = jops.cdc_encode(jnp.asarray(w).astype(jnp.bfloat16), gen)
    got = tops.cdc_encode(torch.from_numpy(w).to(torch.bfloat16), gen)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    close(got.float(), np.asarray(want.astype(jnp.float32)), BTOL)


@pytest.mark.parametrize("T", [3, 6, 12, 32])
@pytest.mark.parametrize("kernel", ["coded_matmul", "fused_head",
                                    "decode_merge", "encode", "decode"])
def test_kernels_refuse_a_code_width_they_have_no_case_for(kernel, T):
    """Each coded kernel's wrapper validates T (and r) before any build or
    launch: every 2 <= T <= 16 (and 1 <= r <= T) passes, as the
    reference's kernels take it; wider codes (T = 17, 32), and r outside
    1..T, raise a ValueError naming T and the widths the kernel takes."""
    check = {"coded_matmul": lambda t: tcdc.check_code(t, 2),
             "fused_head": cdc_decode.check_head,
             "decode_merge": tcdc.check_merge,
             "encode": lambda t: tenc.check_code(t, 2),
             "decode": cdc_decode.check_decode}[kernel]
    if T > 16:
        with pytest.raises(ValueError, match=f"T={T}.*2..16"):
            check(T)
    else:
        check(T)
    with pytest.raises(ValueError, match="T=17.*2..16"):
        check(17)
    for ok in (2, 4, 8, 16):
        check(ok)
    coded = {"coded_matmul": tcdc.check_code,
             "encode": tenc.check_code}.get(kernel)
    if coded is not None:
        for t in (8, 12):
            for r in range(1, t + 1):
                coded(t, r)
        if T <= 16:
            coded(T, T)
            with pytest.raises(ValueError, match=f"T={T}, r={T + 1}"):
                coded(T, T + 1)
        with pytest.raises(ValueError, match="T=16, r=17"):
            coded(16, 17)
