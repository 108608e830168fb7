#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (run from the repo root).

  python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):
  1. print the card's name and power limit; build the CUDA kernels from
     src/repro_torch/csrc (one nvcc per source, in parallel); any ptxas
     spill fails;
  2. hold each kernel against its plain PyTorch version on the card, at
     granite-3-8b's full-width shapes: the parity encode (rtol = atol =
     1e-5; wq, wk, w1 stacked over 40 layers and the head, r = 1..4, both
     layouts, a ragged shape, T = 2, 8 and 16; on bf16 the whole stacked
     encode at N(0, 1) weights within 2e-2, bitwise repeatable), the
     coded GEMM and the fused
     head under the all-valid mask and every single dead shard (float32,
     rtol = atol = 1e-4; the coded GEMM also at (T, r) = (4, 3) dedicated,
     (4, 4) folded, (8, 3) and (8, 4) in both layouts, and T = 16 at r =
     1..4 in both layouts with both producers; the head at T = 16), plus
     an rmsnorm-fold case and a constructed argmax tie across two
     vocabulary tiles; both on bf16 weights within 2e-2 (the reference's
     bf16 oracle bound), every bf16 instantiation launched; the
     decode-and-merge and the r=1 decode (1e-5, every mask with <= 1 dead,
     a NaN in the dead shard, T = 16, the 2048-row shape, both the 16-byte
     and the scalar instantiation), the RMSNorm (1e-5) and the blocked
     GEMM (1e-4, TF32 off), bf16 where a kernel takes it (2e-2, GEMM
     5e-2); kernels 1 and 7 also at the edges of their launch plans (row
     blocks, tile and stage remainders, misaligned views), where every
     instantiation (bulk copies or ordinary loads, 4/8/16 rows a block)
     must launch and repeats must be bitwise equal; kernel 2 also at its
     plan's edges (T = 2, 4, 8, 16; rows 1-17; ragged m_l, k = 4093, an
     offset head, shards apart and stacked; integer-valued inputs, so
     tokens and max equal the plain version's to the bit; float32 and
     bf16) with ties across tiles and across k splits resolving to the
     smaller id, every (T, instantiation) launched, and kernel 6 at rows
     1-1000, d 4096/12800/4093, bf16 and strided rows, bitwise
     repeatable;
  3. serve granite-3-8b at full width (40 layers, d 4096, T=4, r=2 folded,
     float32, random weights from a seeded torch.Generator) through
     ServingEngine.generate: 4 requests, prompt 16, 16 new tokens, fault
     free, with shard 2 killed at step 4, on the reference variant, and on
     it with the norms on their plain version (no kernel at all); the
     token streams must be identical and every fused round must launch the
     coded-GEMM kernel 200 times and the fused head once (its 4-row,
     bulk-copy instantiation). Fused rounds replay captured CUDA graphs
     (one per mask: one replay per fused round, the launches credited to
     the counts) and give the eager fused rounds' tokens fault-free and
     with shard 2 erased; graph and eager rounds are timed in alternating
     blocks in this call, and torch.profiler gives the device time per
     round of each by kernel, and per launch of kernels 2 and 6;
  4. time each kernel at its main-path shape with CUDA events beside its
     plain version, one library call and its bandwidth/compute bound
     (kernel 1 also at 64 rows, kernel 2 at 16, kernels 1 and 2 on bf16
     weights and at T = 16, kernels 3, 5, 6 and 7 at the shapes of their
     own paths; kernels 3 and 5 also by the profiler, at 2048 rows too,
     beside an empty kernel's device time), printing the instantiation
     each took and its ptxas usage;
  5. serve granite-3-8b at full width through the port's serving entry
     point (launch.serve: the continuous-batching scheduler, SimClock, 4
     slots, 8 requests 2 ms apart, prompt 16, 16 new tokens) fault-free,
     under --chaos "exp:mtbf=800,mttr=120" and with --adapt-r as well; every
     request completes with the fault-free run's tokens, the counters equal
     those of the same runs at smoke size on the CPU, the chaos run
     recovers in-step, requeues beyond the budget and re-encodes, the
     planner reaches r=4, every encode launches the encode kernel once per
     parity leaf, and a re-encode of unchanged weights is bitwise equal;
     the re-encode is timed per leaf and whole. Fused rounds replay CUDA
     graphs (one replay per fused round, at most T + 1 graphs per encode,
     dropped at every re-encode and r change). The fault-free run prints
     the --perf line (every launch costed; the fused round's bytes bound
     within 5% of its weights' bytes over the HBM rate), the chaos run
     writes a --trace validated with every injected erasure linked and 0
     dropped events and prints the --slo-report, and the adapt-r run
     writes a --profile trace;
  6. run the paper's coded-cost study through its port
     (launch.coded_overhead: run() and run_kernels() at the reference's
     defaults, T in {4, 8, 16} x r in {1, 2}), print its rows, require the
     r=1 decode, GEMM and encode kernels to have launched and the coded
     outputs to equal x @ w (within the budget);
  7. drive decode_and_merge(use_fused=True), the decode-and-merge kernel's
     library entry, on a coded GEMM's shard outputs at granite widths with
     each shard dead in turn;
  8. serve granite-3-8b at full width at T = 16 (what launch.serve --coded
     --tp 16 builds: float32, r = 2 folded) through ServingEngine.generate,
     fault-free and with shard 5 killed at step 4, on fused rounds (kernel
     1 200 times a round through both producers, kernel 2 once) replayed
     from CUDA graphs, on eager fused rounds, and on the reference variant:
     identical token streams;
  9. a bf16 coded granite-3-8b at full width (Model.init(dtype=bf16), T =
     4, r = 2 folded): its parity encoded by kernel 4 on bf16, 16 tokens
     served through kernels 1, 2 and 6 on bf16 (200 + 1 + 81 launches a
     round) on graph rounds (the eager fused rounds give the same tokens)
     and on the reference variant; the first served round's max
     logit from the fused round's own kernel-2 call within 6e-2 (the
     reference's bf16 TOL) of the reference round's, and where a fused
     stream leaves the reference one, its token within 6e-2 of the
     reference's max (a rounding tie; the split's top-2 gap is logged);
     the leading tokens on which the streams agree reported, device time
     per round by the profiler.
Phases 3 and 5 also count the RMSNorm kernel: 2 x 40 + 1 = 81 launches
per decode round (fused and reference variants) and per prefill.
Peak device memory is printed per phase. The line before the last is the
kernel table as JSON; the last line is {"ok": true, "device": {...}}.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense
SPIN_CYCLES = 4_000_000        # ~2.3 ms at 1.75 GHz: covers any enqueue
TOL = dict(rtol=1e-4, atol=1e-4)
T, R = 4, 2
K = 4096
GEMMS = {"wq": 1024, "wk": 256, "wv": 256, "w1": 3200, "w3": 3200}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 2 ----

def _coded_case(m_l: int, rows: int, layout: str, gen: torch.Generator,
                k: int = K, r: int = R, t: int = T, dtype=torch.float32):
    """A coded GEMM's spec, x [rows, k], w [k, t * m_l] and its parity
    (encoded by kernel 4), stored in ``dtype``."""
    from repro_torch.core.coded_layer import (CodedDenseSpec,
                                              make_parity_weights)
    from repro_torch.core.coding import CodeSpec
    spec = CodedDenseSpec(CodeSpec(t, r), layout=layout)
    x = torch.randn((rows, k), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((k, t * m_l), generator=gen, device="cuda")
         / k ** 0.5).to(dtype)
    return spec, x, w, make_parity_weights(w, spec)


def _run_coded(x, w, wc, spec, valid, gamma=None, plain=False):
    """The kernel (or, with plain=True, its plain version on the same card
    tensors) behind ops.fused_coded_matmul, for one mask."""
    from repro_torch.kernels import cdc_matmul, ops
    vh = tuple(bool(v) for v in valid)
    t, r = spec.code.n_shards, spec.code.n_parity
    m_l = w.shape[1] // t
    esel, coef, g = ops.decode_plan(spec, vh, vh, m_l, str(x.device))
    if plain:
        return cdc_matmul.coded_matmul_plain(x, w, wc, spec.layout, t, r, g,
                                             esel, coef, vh, gamma)
    return cdc_matmul.cdc_coded_matmul(x, w, wc, spec.layout, t, r, g, esel,
                                       coef, vh, gamma=gamma)


def _masks(t: int = T):
    """The all-valid mask and every single dead shard."""
    yield (True,) * t
    for d in range(t):
        yield tuple(i != d for i in range(t))


def check_coded_matmul() -> float:
    """Kernel 1 vs its plain version: every GEMM width x rows in {1,4,16}
    x every mask, plus dedicated-layout, ragged-shape (column tile, k
    chunk) and rmsnorm-fold cases."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = 0.0
    cases = [(m_l, rows, "folded", K) for m_l in sorted(set(GEMMS.values()))
             for rows in (1, 4, 16)] + [(1024, 4, "dedicated", K),
                                        (100, 3, "folded", 1000),
                                        (7, 9, "dedicated", 999)]
    for m_l, rows, layout, k in cases:
        spec, x, w, wc = _coded_case(m_l, rows, layout, gen, k)
        for valid in _masks():
            got = _run_coded(x, w, wc, spec, valid)
            want = _run_coded(x, w, wc, spec, valid, plain=True)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **TOL, msg=lambda m: (
                f"coded matmul m_l={m_l} rows={rows} {layout} "
                f"mask={valid}: {m}"))
            worst = max(worst, float((got - want).abs().max()))
    spec, x, w, wc = _coded_case(1024, 4, "folded", gen)
    gamma = 1.0 + 0.1 * torch.randn(K, generator=gen, device="cuda")
    for valid in [(True,) * T, (True, False, True, True)]:
        got = _run_coded(x, w, wc, spec, valid, gamma=gamma)
        want = _run_coded(x, w, wc, spec, valid, gamma=gamma, plain=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
        worst = max(worst, float((got - want).abs().max()))
    log(f"kernel cdc_coded_matmul: {len(cases) * (T + 1) + 2} cases within "
        f"rtol=atol=1e-4 of the plain version, max abs err {worst:.3e}")
    return worst


def _head(cfg, gen):
    from repro_torch.models.common import TPCtx
    m = TPCtx(tp=T).pad_dim(cfg.vocab)
    w = torch.randn((K, m), generator=gen, device="cuda") / K ** 0.5
    w[:, cfg.vocab:] = 0.0
    return w


def _head_views(w, t: int = T):
    """The [t, k, m_l] shards of a head weight [k, t * m_l] (a view) and
    their sum parity as the serving round holds it."""
    from repro_torch.kernels.cdc_decode import head_parity
    w_shards = w.view(K, t, -1).permute(1, 0, 2)
    return w_shards, head_parity(w_shards)


def _int_head(shape, gen, lo=-1, hi=1):
    """Integer-valued float32 in [lo, hi]: every sum of the fused head's
    inputs is then exact in float32, in any order, so the kernel and its
    plain version must agree to the bit, ties included."""
    return torch.randint(lo, hi + 1, shape, generator=gen,
                         device="cuda").to(torch.float32)


def _head_pair(x, w_shards, pw, valid, vocab, tol=TOL):
    """Kernel 2 and its plain version on the same card tensors: their
    tokens must be equal; returns (tokens, max abs err of the max)."""
    from repro_torch.kernels import cdc_decode, ref
    tok, vmax = cdc_decode.cdc_fused_head_argmax(x, w_shards, pw, valid,
                                                 vocab=vocab)
    rtok, rmax = ref.fused_head_argmax_ref(x, w_shards, pw,
                                           torch.tensor(valid), vocab)
    torch.cuda.synchronize()
    if not torch.equal(tok, rtok):
        raise AssertionError(f"fused head tokens {tok.tolist()} != plain "
                             f"{rtok.tolist()} (mask {valid}, rows "
                             f"{x.shape[0]}, shards {tuple(w_shards.shape)}, "
                             f"vocab {vocab})")
    torch.testing.assert_close(vmax, rmax, **tol)
    return tok, float((vmax - rmax).abs().max())


def check_fused_head(cfg) -> float:
    """Kernel 2 vs its plain version under every mask at granite's head
    (4 and 12 rows, Gaussian weights), and two planted ties that must
    resolve to the smaller id under every mask: across two column tiles
    and across two k splits (integer-valued weights, so the tie is exact
    on both sides)."""
    from repro_torch.kernels import cdc_decode, cdc_matmul
    gen = torch.Generator(device="cuda").manual_seed(12)
    w = _head(cfg, gen)
    x = torch.randn((4, K), generator=gen, device="cuda")
    w_shards, pw = _head_views(w)
    worst = 0.0
    # every mask at the main path's 4 rows, and 12 rows (two row blocks)
    x12 = torch.randn((12, K), generator=gen, device="cuda")
    for xs, valid in [(x, m) for m in _masks()] + [(x12, (True,) * T)]:
        worst = max(worst, _head_pair(xs, w_shards, pw, valid,
                                      cfg.vocab)[1])
    m_l = w.shape[1] // T
    plan = cdc_decode.head_plan(4, K, m_l, T, cdc_matmul._n_sm(x.device),
                                cdc_decode.head_occupancy(T, 4, True))
    kc = plan.kchunk
    if plan.ksplit < 2 or plan.bn > 9000:
        raise AssertionError(f"the tie cases need split k and several "
                             f"tiles: {plan}")
    # a tie across tiles: gid 1 * m_l + 10 (shard 1, tile 0) and gid 9000
    # (shard 0, a late tile); across splits: gid 3 * m_l + 20 with weights
    # only in split 0's k range and gid 2 * m_l + 40 with them only in
    # split 1's, x repeating itself there. Planted 8s beat every other
    # column (|w| <= 1) by far.
    ties = {"tiles": ((1 * m_l + 10, None), (9000, None)),
            "splits": ((3 * m_l + 20, (0, kc)), (2 * m_l + 40, (kc, 2 * kc)))}
    for name, cols in ties.items():
        w = _int_head((K, T * m_l), gen)
        x = _int_head((4, K), gen, 1, 2)
        for gid, ks in cols:
            w[:, gid] = 0.0 if ks else 8.0
            if ks:
                w[ks[0]:ks[1], gid] = 8.0
        if name == "splits":
            x[:, kc:2 * kc] = x[:, :kc]
        w_shards, pw = _head_views(w)
        want = min(gid for gid, _ in cols)
        for valid in _masks():
            tok, _ = _head_pair(x, w_shards, pw, valid, cfg.vocab)
            if tok.tolist() != [want] * 4:
                raise AssertionError(f"tie across {name} must resolve to "
                                     f"id {want}: {tok.tolist()} (mask "
                                     f"{valid})")
        del w, w_shards, pw
    log(f"kernel cdc_fused_head_argmax: {T + 2} cases equal tokens, max "
        f"within 1e-4 (max abs err {worst:.3e}); ties across tiles and "
        f"across splits -> the smaller id under every mask")
    return worst


def head_variants(bf16: bool = False) -> tuple:
    """Every (T, instantiation) of kernel 2 in one storage type: rows
    blocks of 4, 8 and (up to 11 streams) 16, bulk copies or loads."""
    from repro_torch.kernels.stream_plan import rb16_fits
    return tuple((t, f"rb{rb}-{p}" + ("-bf16" if bf16 else ""))
                 for t in (2, 4, 8, 16) for rb in (4, 8, 16)
                 if rb < 16 or rb16_fits(t + 1)
                 for p in ("async", "loads"))


def check_head_edges(dtype=torch.float32) -> float:
    """Kernel 2 at the edges of its launch plan, against its plain version
    under every mask with <= 1 dead shard: granite's head at T = 2, 4, 8
    and 16 (T = 2's m_l = 24578 takes the ordinary loads) and rows 1, 4,
    5, 8, 9, 12 and 17 (the row blocks 4 | 8 | 16 and their remainders;
    T = 16 has blocks of 4 and 8 rows), vocab 49155 (it cuts the last
    shard's last tile); T = 2 at an aligned m_l = 12292; ragged m_l 1001
    and 2051 (ordinary loads, each row block) with the vocab cut 7 columns
    short; k = 4093; the head at a 4-byte offset (ordinary loads at
    granite's width); column shards 4 and 8 columns apart (the 2-D map
    at shard offsets off and on a 16-byte boundary) and shards stored one
    after another (the 3-D map). Integer-valued inputs, exact in bf16
    too: tokens and max must equal the plain version's to the bit, ties
    (frequent here) included. Every (T, instantiation) of the storage
    type must launch (on bf16, granite's T = 4 head, whose shards start
    between 16-byte boundaries, with box rows a vector wider than the
    tile), and two launches on the same inputs give the same bits."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import cdc_decode
    vocab = get_arch("granite-3-8b").vocab
    bf16 = dtype == torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(24)
    rows_all = (1, 4, 5, 8, 9, 12, 17)
    ts = (2, 4, 8, 16)
    # (T, m_l, k, rows, offset, vocab, gap between shards: None = stacked)
    cases = [(t, _pad_head(vocab, t), K, rows_all, 0, vocab, 0) for t in ts]
    cases += [(2, 12292, K, (4, 5, 9), 0, 2 * 12292 - 5, 0)]
    cases += [(t, 1001, 4093, (4, 5), 0, t * 1001 - 7, 0) for t in ts]
    cases += [(t, 2051, K, (17,), 0, t * 2051 - 7, 0) for t in ts]
    cases += [(4, 12292, 4093, (4,), 0, vocab, 0),
              (4, 12292, K, (4, 9), 1, vocab, 0)]
    cases += [(4, 2048, K, (4, 9), 0, 4 * 2048 - 7, gap)
              for gap in (4, 8, None)]
    seen, worst, n, lead = set(), 0.0, 0, 0
    for t, m_l, k, rows_list, offset, voc, gap in cases:
        if gap is None:
            buf = w_shards = _int_head((t, k, m_l), gen).to(dtype)
        else:
            buf = _int_head((k, t * (m_l + gap) + offset), gen).to(dtype)
            w_shards = buf[:, offset:].reshape(k, t, m_l + gap)[..., :m_l] \
                .permute(1, 0, 2)
        pw = cdc_decode.head_parity(w_shards)
        for rows in rows_list:
            x = _int_head((rows, k), gen, -2, 2).to(dtype)
            for valid in _masks(t):
                cdc_decode.cdc_fused_head_argmax.variants.clear()
                _, err = _head_pair(x, w_shards, pw, valid, voc)
                variant, = cdc_decode.cdc_fused_head_argmax.variants
                seen.add((t, variant.replace("-lead", "")))
                lead += "-lead" in variant
                if err != 0.0:
                    raise AssertionError(f"fused head max differs by {err} "
                                         f"on exact inputs (T={t}, m_l="
                                         f"{m_l}, k={k}, rows={rows}, "
                                         f"{dtype})")
                worst, n = max(worst, err), n + 1
        del buf, w_shards, pw
    missing = [v for v in head_variants(bf16) if v not in seen]
    if missing or (bf16 and not lead):
        raise AssertionError(f"kernel 2 instantiations never launched: "
                             f"{missing} (launched {sorted(seen)}; "
                             f"{lead} launches with widened boxes)")
    # bitwise repeat at the decode round's split plan, Gaussian inputs
    w = (torch.randn((K, T * 12292), generator=gen, device="cuda")
         / K ** 0.5).to(dtype)
    w_shards, pw = _head_views(w)
    x = torch.randn((4, K), generator=gen, device="cuda")
    a = cdc_decode.cdc_fused_head_argmax(x, w_shards, pw,
                                         (True, False, True, True),
                                         vocab=vocab)
    b = cdc_decode.cdc_fused_head_argmax(x, w_shards, pw,
                                         (True, False, True, True),
                                         vocab=vocab)
    torch.cuda.synchronize()
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
        raise AssertionError("fused head: two launches on the same inputs "
                             "differ")
    log(f"kernel cdc_fused_head_argmax at its plan's edges ({dtype}): {n} "
        f"cases (T 2/4/8/16, rows 1-17, m_l 1001/2051/12292/granite, k "
        f"4093, offset head, shards 4 and 8 columns apart, stacked shards, "
        f"every mask) equal to the plain version to the bit; repeats "
        f"bitwise equal; (T, instantiation) launched "
        f"{sorted(seen)}")
    return worst


def _pad_head(vocab: int, t: int) -> int:
    """m_l of the head shards at t (the vocabulary padded to t * t)."""
    from repro_torch.models.common import TPCtx
    return TPCtx(tp=t).pad_dim(vocab) // t


def check_coded_matmul_r34() -> float:
    """Kernel 1 at the two cases the planner reaches beyond r=2 at T=4:
    (4, 3) dedicated and (4, 4) folded, at the main path's GEMM widths and
    4 rows, under the all-valid mask and every single dead shard."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    worst, n = 0.0, 0
    for r, layout in ((3, "dedicated"), (4, "folded")):
        for m_l in sorted(set(GEMMS.values())):
            spec, x, w, wc = _coded_case(m_l, 4, layout, gen, r=r)
            for valid in _masks():
                got = _run_coded(x, w, wc, spec, valid)
                want = _run_coded(x, w, wc, spec, valid, plain=True)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, **TOL, msg=lambda m: (
                    f"coded matmul (4, {r}) {layout} m_l={m_l} mask={valid}"
                    f": {m}"))
                worst = max(worst, float((got - want).abs().max()))
                n += 1
    log(f"kernel cdc_coded_matmul at (T, r) = (4, 3) dedicated and (4, 4) "
        f"folded: {n} cases within rtol=atol=1e-4 of the plain version, "
        f"max abs err {worst:.3e}")
    return worst


def check_coded_matmul_t8() -> float:
    """Kernel 1 at the cases the planner reaches at T=8 folded (r = 2 x
    the default budget of 2 = 4) and (8, 3): both layouts, granite-3-8b's
    coded GEMM widths divided by 8 (wq 512, wk 128, w1 1600), 4 rows, the
    all-valid mask and every single dead shard."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    worst, n = 0.0, 0
    for r in (3, 4):
        for layout in ("folded", "dedicated"):
            for m_l in (512, 128, 1600):
                spec, x, w, wc = _coded_case(m_l, 4, layout, gen, r=r, t=8)
                for valid in _masks(8):
                    got = _run_coded(x, w, wc, spec, valid)
                    want = _run_coded(x, w, wc, spec, valid, plain=True)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got, want, **TOL,
                                               msg=lambda m: (
                        f"coded matmul (8, {r}) {layout} m_l={m_l} "
                        f"mask={valid}: {m}"))
                    worst = max(worst, float((got - want).abs().max()))
                    n += 1
    log(f"kernel cdc_coded_matmul at (T, r) = (8, 3) and (8, 4), both "
        f"layouts: {n} cases within rtol=atol=1e-4 of the plain version, "
        f"max abs err {worst:.3e}")
    return worst


T16 = 16
GEMMS16 = {"wq": 256, "wk": 64, "w1": 800}   # granite's widths / 16
BF16_TOL = dict(rtol=2e-2, atol=2e-2)         # the reference's bf16 oracle


def _coded_pair(x, w, wc, spec, valid, tol, what: str) -> float:
    """Kernel 1 and its plain version on the same card tensors, within
    ``tol``; returns the max abs error."""
    got = _run_coded(x, w, wc, spec, valid)
    want = _run_coded(x, w, wc, spec, valid, plain=True)
    torch.cuda.synchronize()
    if got.dtype != x.dtype:
        raise AssertionError(f"coded matmul {what}: output {got.dtype}, "
                             f"want x's {x.dtype}")
    torch.testing.assert_close(got, want, **tol, msg=lambda m: (
        f"coded matmul {what} mask={valid}: {m}"))
    return float((got.float() - want.float()).abs().max())


def check_coded_matmul_t16() -> float:
    """Kernel 1 at T = 16 (its (16, 1)-(16, 4) cases), both layouts,
    granite-3-8b's coded GEMM widths divided by 16 (wq 256, wk 64, w1 800:
    folded w1's slices of 50 columns take the copy engine with box rows a
    vector wider than the tile (`-lead`) at r = 2 and 4, and the ordinary
    loads at r = 1 and 3, whose parity rows are no whole 16-byte vectors),
    4 rows, the all-valid mask and every single dead shard, within 1e-4
    of the plain version; 5 and 9 rows take the 8-row blocks (T = 16 has
    no 16-row instantiation). Both producers must launch at both row
    blocks, and the widened boxes at both."""
    from repro_torch.kernels import cdc_matmul
    gen = torch.Generator(device="cuda").manual_seed(26)
    cdc_matmul.cdc_coded_matmul.variants.clear()
    worst, n = 0.0, 0
    cases = [(m_l, 4, layout, r) for layout in ("folded", "dedicated")
             for r in (1, 2, 3, 4) for m_l in GEMMS16.values()]
    cases += [(800, 5, "folded", 3), (800, 9, "folded", 4),
              (256, 9, "folded", 2), (64, 5, "dedicated", 3)]
    for m_l, rows, layout, r in cases:
        spec, x, w, wc = _coded_case(m_l, rows, layout, gen, r=r, t=T16)
        masks = list(_masks(T16)) if rows == 4 else \
            [(True,) * T16, tuple(i != 7 for i in range(T16))]
        for valid in masks:
            worst = max(worst, _coded_pair(
                x, w, wc, spec, valid, TOL,
                f"(16, {r}) {layout} m_l={m_l} rows={rows}"))
            n += 1
    seen = dict(cdc_matmul.cdc_coded_matmul.variants)
    want = {f"rb{rb}-{p}" for rb in (4, 8)
            for p in ("async", "loads", "async-lead")}
    if set(seen) != want:
        raise AssertionError(f"kernel 1 at T = 16 launched {seen}; want "
                             f"every one of {sorted(want)}")
    log(f"kernel cdc_coded_matmul at T = 16, r = 1-4, both layouts: {n} "
        f"cases within rtol=atol=1e-4 of the plain version, max abs err "
        f"{worst:.3e}; launches per instantiation {seen}")
    return worst


def check_coded_matmul_bf16() -> float:
    """Kernel 1 on bf16 storage (x, weights, parity and output bf16; math
    float32) against its plain version within 2e-2, the reference's bf16
    oracle bound: granite-3-8b's GEMMs at T = 4, r = 2 folded (wq, wk, w1;
    4 rows under every mask, 16 and 64 rows), w1 at (4, 4) and wq
    dedicated; the plan's edges (rows 5, 8, 9; k = 4093; m_l = 1000
    dedicated; a ragged m_l = 100 and w's rows at an odd offset, both on
    the ordinary loads); T = 8 at r = 4 and T = 16 at r = 2 (w1 800 on the
    loads, wq 256 on the copy engine); float32 x against bf16 weights
    (float32 out). Every bf16 instantiation (4/8/16 rows, bulk copies or
    loads) must launch, and repeats at a split plan are bitwise equal."""
    from repro_torch.kernels import cdc_matmul
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(27)
    cdc_matmul.cdc_coded_matmul.variants.clear()
    worst, n = 0.0, 0
    cases = [(m_l, 4, "folded", K, R, T) for m_l in (1024, 256, 3200)]
    cases += [(m_l, rows, "folded", K, R, T) for m_l in (1024, 3200)
              for rows in (5, 8, 9, 16, 64)]
    cases += [(3200, 4, "folded", K, 4, T), (1024, 4, "dedicated", K, R, T),
              (1000, 9, "dedicated", 4093, R, T),
              (100, 5, "folded", 1000, R, T), (512, 4, "folded", K, 4, 8),
              (800, 4, "folded", K, R, T16), (256, 9, "folded", K, R, T16)]
    for m_l, rows, layout, k, r, t in cases:
        spec, x, w, wc = _coded_case(m_l, rows, layout, gen, k, r, t, bf)
        masks = list(_masks(t)) if (rows == 4 and t == T) else \
            [(True,) * t, tuple(i != 1 for i in range(t))]
        for valid in masks:
            worst = max(worst, _coded_pair(
                x, w, wc, spec, valid, BF16_TOL,
                f"bf16 ({t}, {r}) {layout} m_l={m_l} rows={rows} k={k}"))
            n += 1
    # float32 activations against bf16 weights: float32 out
    spec, x, w, wc = _coded_case(1024, 4, "folded", gen, dtype=bf)
    worst = max(worst, _coded_pair(x.float(), w, wc, spec, (True,) * T,
                                   BF16_TOL, "f32 x, bf16 weights"))
    # w's rows at a 2-byte offset: the ordinary loads at granite's widths
    for rows, m_l in ((4, 1024), (9, 3200)):
        spec, x, w, wc = _coded_case(m_l, rows, "folded", gen, dtype=bf)
        wide = torch.zeros((K, T * m_l + 1), device="cuda", dtype=bf)
        wide[:, 1:] = w
        got = _run_coded(x, wide[:, 1:], wc, spec, (True,) * T)
        want = _run_coded(x, w, wc, spec, (True,) * T, plain=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **BF16_TOL)
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        n += 1
    spec, x, w, wc = _coded_case(3200, 4, "folded", gen, dtype=bf)
    a = _run_coded(x, w, wc, spec, (True, True, False, True))
    b = _run_coded(x, w, wc, spec, (True, True, False, True))
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("bf16 coded matmul: two launches differ")
    seen = dict(cdc_matmul.cdc_coded_matmul.variants)
    missing = [v + "-bf16" for v in CODED_VARIANTS if v + "-bf16" not in seen]
    if missing:
        raise AssertionError(f"bf16 instantiations never launched: "
                             f"{missing} (launched {seen})")
    log(f"kernel cdc_coded_matmul on bf16: {n} cases within rtol=atol=2e-2 "
        f"of the plain version (output in x's dtype), max abs err "
        f"{worst:.3e}; repeats bitwise equal; launches per instantiation "
        f"{seen}")
    return worst


def check_fused_head_wide(cfg) -> float:
    """Kernel 2 at granite's head under every mask, Gaussian weights: at
    T = 16 (m_l = 3088, 4 rows, float32, within 1e-4) and on bf16 weights
    at T = 4 (m_l = 12292, read through the 2-D map) and T = 16, with
    float32 x as the serving round gives it and with bf16 x (max within
    2e-2; tokens equal)."""
    from repro_torch.models.common import TPCtx
    gen = torch.Generator(device="cuda").manual_seed(28)
    worst, n = 0.0, 0
    for t, dtype in ((T16, torch.float32), (T, torch.bfloat16),
                     (T16, torch.bfloat16)):
        m = TPCtx(tp=t).pad_dim(cfg.vocab)
        w = torch.randn((K, m), generator=gen, device="cuda") / K ** 0.5
        w[:, cfg.vocab:] = 0.0
        w_shards, pw = _head_views(w.to(dtype), t)
        tol = TOL if dtype == torch.float32 else BF16_TOL
        x = torch.randn((4, K), generator=gen, device="cuda")
        xs = [x] + ([x.to(dtype)] if dtype != torch.float32 else [])
        for xi in xs:
            for valid in _masks(t):
                worst = max(worst, _head_pair(xi, w_shards, pw, valid,
                                              cfg.vocab, tol)[1])
                n += 1
        del w, w_shards, pw
    log(f"kernel cdc_fused_head_argmax at T = 16 (float32, 1e-4) and on "
        f"bf16 weights at T = 4 and 16 (2e-2): {n} cases, equal tokens, "
        f"max abs err {worst:.3e}")
    return worst


CODED_VARIANTS = tuple(f"rb{rb}-{p}" for rb in (4, 8, 16)
                       for p in ("async", "loads"))
MATMUL_VARIANTS = tuple(f"rows-{v}" for v in CODED_VARIANTS) + (
    "square-async", "square-loads")


def check_stream_edges() -> tuple[float, float]:
    """Kernels 1 and 7 at the edges of their launch plans, against their
    plain versions (1e-4, TF32 off): kernel 1 at rows 5, 8 and 9 (the row
    block boundaries 4 | 8 | 16), m_l = 1000 dedicated (not a multiple of
    the column tile), k = 4093 (not a multiple of the stage depth), w's
    rows at an odd stride and offset (the ordinary-load instantiation, at
    granite's wq and w1 widths), (4, 4) and (8, 4) folded; kernel 7 at
    m = 1, 5, 8, 9, 12, 16 and 17, n = 1000, 2048, 2050 and 70, k = 4093
    and 300, bf16 in. Each instantiation of both kernels must have run, and
    two launches on the same inputs must give bitwise the same output.
    Returns the two kernels' max abs errors."""
    from repro_torch.kernels import cdc_matmul, matmul, ref
    gen = torch.Generator(device="cuda").manual_seed(22)
    cdc_matmul.cdc_coded_matmul.variants.clear()
    matmul.matmul.variants.clear()
    worst, n = 0.0, 0
    cases = [(m_l, rows, "folded", K, R, T) for m_l in (1024, 3200)
             for rows in (5, 8, 9)]
    cases += [(1000, 4, "dedicated", K, R, T), (1024, 4, "folded", 4093, R, T),
              (1024, 5, "folded", 4093, R, T), (3200, 5, "folded", K, 4, T),
              (3200, 9, "folded", K, 4, T), (512, 9, "folded", K, 4, 8),
              (100, 5, "folded", 1000, R, T)]
    for m_l, rows, layout, k, r, t in cases:
        spec, x, w, wc = _coded_case(m_l, rows, layout, gen, k, r, t)
        for valid in ((True,) * t, tuple(i != 1 for i in range(t))):
            got = _run_coded(x, w, wc, spec, valid)
            want = _run_coded(x, w, wc, spec, valid, plain=True)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **TOL, msg=lambda m: (
                f"coded matmul ({t}, {r}) {layout} m_l={m_l} rows={rows} "
                f"k={k} mask={valid}: {m}"))
            worst = max(worst, float((got - want).abs().max()))
            n += 1
    # w's rows at an odd stride and a 4-byte offset: no tensor map can take
    # them, so the same kernel runs with ordinary loads
    for rows, m_l in ((4, 1024), (9, 1024), (9, 3200)):
        spec, x, w, _ = _coded_case(m_l, rows, "folded", gen)
        wide = torch.zeros((K, T * m_l + 1), device="cuda")
        wide[:, 1:] = w
        wv = wide[:, 1:]
        from repro_torch.core.coded_layer import make_parity_weights
        wc = make_parity_weights(wv.contiguous(), spec)
        got = _run_coded(x, wv, wc, spec, (True,) * T)
        want = _run_coded(x, w, wc, spec, (True,) * T, plain=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
        worst = max(worst, float((got - want).abs().max()))
        n += 1
    # bitwise repeat at split plans (w1 and wk at 4 rows)
    for m_l in (3200, 256):
        spec, x, w, wc = _coded_case(m_l, 4, "folded", gen)
        a = _run_coded(x, w, wc, spec, (True, True, False, True))
        b = _run_coded(x, w, wc, spec, (True, True, False, True))
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"coded matmul m_l={m_l}: two launches on "
                                 f"the same inputs differ")
    worst1, worst = worst, 0.0
    mm_cases = [((m, K, 1000), torch.float32, None) for m in (1, 5, 8, 9, 16)]
    mm_cases += [((4, 4093, 4096), torch.float32, None),
                 ((4, 300, 70), torch.float32, None),
                 ((5, 300, 70), torch.float32, None),
                 ((12, 300, 70), torch.float32, None),
                 ((9, 512, 2048), torch.float32, None),
                 ((12, 300, 2050), torch.float32, None),
                 ((17, 300, 96), torch.float32, None),
                 ((100, 300, 70), torch.float32, None),
                 ((4, 512, 512), torch.bfloat16, torch.float32)]
    for (m, k, nn), dt, odt in mm_cases:
        x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
        w = (torch.randn((k, nn), generator=gen, device="cuda")
             / k ** 0.5).to(dt)
        got = matmul.matmul(x, w, out_dtype=odt)
        want = ref.matmul_ref(x, w, odt)
        torch.cuda.synchronize()
        tol = 1e-4 if dt == torch.float32 else 5e-2
        torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                                   msg=lambda s: f"matmul ({m}, {k}, {nn}) "
                                                 f"{dt}: {s}")
        if dt == torch.float32:
            worst = max(worst, float((got - want).abs().max()))
        n += 1
    x = torch.randn((4, K), generator=gen, device="cuda")
    w = torch.randn((K, K), generator=gen, device="cuda")
    if not torch.equal(matmul.matmul(x, w), matmul.matmul(x, w)):
        raise AssertionError("matmul (4, 4096, 4096): two launches on the "
                             "same inputs differ")
    seen = (dict(cdc_matmul.cdc_coded_matmul.variants),
            dict(matmul.matmul.variants))
    missing = [v for v in CODED_VARIANTS if v not in seen[0]] + \
        [v for v in MATMUL_VARIANTS if v not in seen[1]]
    if missing:
        raise AssertionError(f"instantiations never launched: {missing} "
                             f"(launched {seen})")
    log(f"kernels cdc_coded_matmul and matmul at their plans' edges: {n} "
        f"cases within rtol=atol=1e-4 (bf16 5e-2) of the plain versions, "
        f"max abs err {worst1:.3e} / {worst:.3e}; repeats bitwise equal; "
        f"launches per instantiation {seen[0]} / {seen[1]}")
    return worst1, worst


def _dm_plan(spec, valid, m_l):
    from repro_torch.kernels import ops
    vh = tuple(bool(v) for v in valid)
    esel, coef, g = ops.decode_plan(spec, vh, vh, m_l, "cuda")
    return vh, esel, coef, g


def check_decode_merge() -> float:
    """Kernel 3 vs its plain version (rtol = atol = 1e-5 at float32, 2e-2
    at bf16): T in {2, 4, 8} x r in {1, 2} x both layouts x every mask
    with <= 1 dead x rows in {4, 64} x m_l in {3200 (granite w1), 1024
    (wq), 100 (ragged; 104 folded at T=8, which needs m_l % 8 == 0)}; T =
    16 at granite's w1 / 16 (800; folded slices of 50 columns take the
    scalar path); the 2048-row shape [4, 2048, 3200] (float32 and bf16);
    a column plan whose equations differ within a 16-byte group. The dead
    shard's outputs are NaN: the select must keep them out. Both
    instantiations (16-byte groups and scalar) must launch. 2 dead shards
    must take the reference decode_and_merge, launching nothing."""
    from repro_torch.core.coded_layer import CodedDenseSpec, decode_and_merge
    from repro_torch.core.coding import CodeSpec
    from repro_torch.kernels import cdc_matmul, ops
    gen = torch.Generator(device="cuda").manual_seed(17)
    worst, n = 0.0, 0
    cases = [(t, r, layout, rows, m_l, torch.float32)
             for t in (2, 4, 8) for r in (1, 2)
             for layout in ("folded", "dedicated") for rows in (4, 64)
             for m_l in (3200, 1024, 104 if layout == "folded" and t == 8
                         else 100)]
    cases += [(4, 2, "folded", 4, 3200, torch.bfloat16),
              (8, 1, "dedicated", 64, 100, torch.bfloat16),
              (16, 2, "folded", 4, 800, torch.float32),
              (16, 2, "dedicated", 64, 800, torch.bfloat16),
              (4, 2, "folded", 2048, 3200, torch.float32),
              (4, 2, "dedicated", 2048, 3200, torch.float32),
              (4, 2, "folded", 2048, 3200, torch.bfloat16)]
    cdc_matmul.cdc_decode_merge.variants.clear()
    for t, r, layout, rows, m_l, dt in cases:
        spec = CodedDenseSpec(CodeSpec(t, r), layout=layout)
        ys = torch.randn((t, rows, m_l), generator=gen, device="cuda")
        pshape = (t, rows, r * m_l // t) if layout == "folded" \
            else (r, rows, m_l)
        par = torch.randn(pshape, generator=gen, device="cuda").to(dt)
        for valid in _masks(t):
            yv = ys.clone()
            for d in range(t):
                if not valid[d]:
                    yv[d] = float("nan")
            yv = yv.to(dt)
            vh, esel, coef, g = _dm_plan(spec, valid, m_l)
            got = cdc_matmul.cdc_decode_merge(yv, par, layout, t, r, g, esel,
                                              coef, vh)
            want = cdc_matmul.decode_merge_plain(yv, par, layout, t, r, g,
                                                 esel, coef, vh)
            torch.cuda.synchronize()
            tol = 1e-5 if dt == torch.float32 else 2e-2
            torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                                       msg=lambda m: (
                f"decode_merge T={t} r={r} {layout} rows={rows} m_l={m_l} "
                f"{dt} mask={valid}: {m}"))
            if dt == torch.float32:
                worst = max(worst, float((got - want).abs().max()))
            n += 1
    # equations that differ from column to column inside a 16-byte group
    # (no plan of eq12_plan makes them): per-column parity reads
    spec = CodedDenseSpec(CodeSpec(4, 2), layout="dedicated")
    ys = torch.randn((4, 64, 1024), generator=gen, device="cuda")
    par = torch.randn((2, 64, 1024), generator=gen, device="cuda")
    valid = (True, False, True, True)
    vh, _, _, g = _dm_plan(spec, valid, 1024)
    esel = torch.arange(1024, device="cuda", dtype=torch.int32) % 2
    coef = (1.0 / g[esel.long(), 1]).contiguous()
    got = cdc_matmul.cdc_decode_merge(ys, par, "dedicated", 4, 2, g, esel,
                                      coef, vh)
    want = cdc_matmul.decode_merge_plain(ys, par, "dedicated", 4, 2, g, esel,
                                         coef, vh)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    worst, n = max(worst, float((got - want).abs().max())), n + 1
    seen = dict(cdc_matmul.cdc_decode_merge.variants)
    if set(seen) != {"vec", "scalar"}:
        raise AssertionError(f"kernel 3 instantiations launched {seen}")
    # 2 dead shards (in budget for dedicated r=2): the reference path,
    # bit for bit, and no kernel launch
    spec = CodedDenseSpec(CodeSpec(4, 2), layout="dedicated")
    ys = torch.randn((4, 2, 3, 1024), generator=gen, device="cuda")
    par = torch.randn((2, 2, 3, 1024), generator=gen, device="cuda")
    two_dead = np.array([True, False, True, False])
    before = cdc_matmul.cdc_decode_merge.launches
    got = ops.fused_decode_merge(ys, par, spec, two_dead)
    if cdc_matmul.cdc_decode_merge.launches != before or not torch.equal(
            got, decode_and_merge(ys, par, spec, two_dead)):
        raise AssertionError("2 dead shards must take the reference "
                             "decode_and_merge without a kernel launch")
    log(f"kernel cdc_decode_merge: {n} cases (T = 2, 4, 8, 16; r = 1, 2; "
        f"both layouts; rows 4, 64, 2048; m_l 3200, 1024, 800, ragged; NaN "
        f"in the dead shard; bf16 sets; mixed equations in a group) within "
        f"rtol=atol=1e-5 (bf16 2e-2) of the plain version, max abs err "
        f"{worst:.3e}; launches per instantiation {seen}; 2 dead -> the "
        f"reference path")
    return worst


def check_decode() -> float:
    """Kernel 5 vs its plain version (rtol = atol = 1e-5 at float32, 2e-2
    at bf16): T in {2, 4, 8, 16} at [T, 256, 512] (the study's shape) and
    [T, 4, 3200], [4, 2048, 3200] (float32 and bf16) and a ragged [4, 3,
    333] (the scalar path), all valid and every single dead shard; both
    instantiations must launch; a NaN in the dead shard must propagate
    exactly as in the plain version (multiply semantics); 2 dead shards
    must raise."""
    from repro_torch.kernels import cdc_decode, ops, ref
    gen = torch.Generator(device="cuda").manual_seed(18)
    worst, n = 0.0, 0
    cases = [(t, shape, torch.float32) for t in (2, 4, 8, 16)
             for shape in ((256, 512), (4, 3200))]
    cases += [(8, (256, 512), torch.bfloat16), (4, (4, 3200), torch.bfloat16),
              (4, (2048, 3200), torch.float32),
              (4, (2048, 3200), torch.bfloat16),
              (4, (3, 333), torch.float32), (16, (3, 333), torch.bfloat16)]
    cdc_decode.cdc_decode.variants.clear()
    for t, shape, dt in cases:
        y = torch.randn((t,) + shape, generator=gen, device="cuda")
        p = y.sum(0).to(dt)
        y = y.to(dt)
        for valid in _masks(t):
            got = cdc_decode.cdc_decode(y, p, valid)
            want = ref.cdc_decode_ref(y, p, torch.tensor(valid,
                                                          device="cuda"))
            torch.cuda.synchronize()
            tol = 1e-5 if dt == torch.float32 else 2e-2
            torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                                       msg=lambda m: (
                f"decode T={t} {shape} {dt} mask={valid}: {m}"))
            if dt == torch.float32:
                worst = max(worst, float((got - want).abs().max()))
            n += 1
    y = torch.randn((4, 4, 3200), generator=gen, device="cuda")
    p = y.sum(0)
    y[1, :, ::7] = float("nan")
    valid = (True, False, True, True)
    got = cdc_decode.cdc_decode(y, p, valid)
    want = ref.cdc_decode_ref(y, p, torch.tensor(valid, device="cuda"))
    torch.cuda.synchronize()
    if not (torch.equal(got.isnan(), want.isnan()) and got.isnan().any()):
        raise AssertionError("a NaN in the dead shard must propagate as in "
                             "the plain version")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                               equal_nan=True)
    try:
        ops.cdc_decode(y, p, (True, False, False, True))
    except ValueError:
        pass
    else:
        raise AssertionError("cdc_decode must refuse 2 dead shards")
    seen = dict(cdc_decode.cdc_decode.variants)
    if set(seen) != {"vec", "scalar"}:
        raise AssertionError(f"kernel 5 instantiations launched {seen}")
    log(f"kernel cdc_decode: {n} cases (T = 2, 4, 8, 16 at [T, 256, 512] "
        f"and [T, 4, 3200], [4, 2048, 3200], ragged [T, 3, 333], every "
        f"single erasure, bf16 sets) within rtol=atol=1e-5 (bf16 2e-2), max "
        f"abs err {worst:.3e}; launches per instantiation {seen}; NaN in "
        f"the dead shard propagates as in the plain version; 2 dead raise")
    return worst


def check_rmsnorm() -> float:
    """Kernel 6 vs its plain version at d = 4096, eps = 1e-5: rows in {1,
    4, 64, 3000} at float32 (rtol = atol = 1e-5), a [4, 16, 4096] input
    (leading dimensions flattened) and its last positions (rows at a
    stride), and bf16 at 4 and 64 rows (2e-2)."""
    from repro_torch.kernels import ref, rmsnorm
    gen = torch.Generator(device="cuda").manual_seed(19)
    g = 1.0 + 0.1 * torch.randn(K, generator=gen, device="cuda")
    worst, n = 0.0, 0
    cases = [((rows, K), torch.float32) for rows in (1, 4, 64, 3000)]
    cases += [((4, 16, K), torch.float32), ((4, 16, K), "last"),
              ((4, K), torch.bfloat16), ((64, K), torch.bfloat16)]
    for shape, dt in cases:
        x = 3.0 * torch.randn(shape, generator=gen, device="cuda")
        if dt == "last":       # the last position of each row: strided rows
            x, dt = x[:, -1:], torch.float32
        x = x.to(dt)
        got = rmsnorm.rmsnorm(x, g, eps=1e-5)
        want = ref.rmsnorm_ref(x, g, 1e-5)
        torch.cuda.synchronize()
        tol = 1e-5 if dt == torch.float32 else 2e-2
        torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                                   msg=lambda m: f"rmsnorm {shape} {dt}: {m}")
        if dt == torch.float32:
            worst = max(worst, float((got - want).abs().max()))
        n += 1
    log(f"kernel rmsnorm: {n} cases (rows 1, 4, 64, 3000, [4, 16, 4096] "
        f"and its strided last positions at float32, d = 4096, eps = 1e-5; "
        f"bf16 at 4 and 64 rows) within "
        f"rtol=atol=1e-5 (bf16 2e-2), max abs err {worst:.3e}")
    return worst


def check_rmsnorm_edges() -> float:
    """Kernel 6 at the edges of its plan, against its plain version (1e-5,
    bf16 2e-2): rows 1, 4, 64 and 1000 at d = 4096, 12800 and 4093
    (4093: the scalar instantiation), bf16 at 4 and 1000 rows, rows at a
    stride of d + 8 (vectors) and d + 1 (scalar). Every instantiation the
    plan names must launch, and a second launch on the same inputs gives
    the same bits."""
    from repro_torch.kernels import ref, rmsnorm
    gen = torch.Generator(device="cuda").manual_seed(25)
    rmsnorm.rmsnorm.variants.clear()
    cases = [((rows, d), torch.float32, 0)
             for d in (4096, 12800, 4093) for rows in (1, 4, 64, 1000)]
    cases += [((rows, d), torch.bfloat16, 0)
              for d in (4096, 12800, 4093) for rows in (4, 1000)]
    cases += [((64, d), torch.float32, pad)
              for d in (4096, 12800) for pad in (8, 1)]
    want, worst = set(), 0.0
    for (rows, d), dt, pad in cases:
        g = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        base = 3.0 * torch.randn((rows, d + pad), generator=gen,
                                 device="cuda")
        x = base.to(dt)[:, :d]
        got = rmsnorm.rmsnorm(x, g, eps=1e-5)
        again = rmsnorm.rmsnorm(x, g, eps=1e-5)
        plain = ref.rmsnorm_ref(x, g, 1e-5)
        torch.cuda.synchronize()
        tol = 1e-5 if dt == torch.float32 else 2e-2
        torch.testing.assert_close(got, plain, rtol=tol, atol=tol,
                                   msg=lambda m: (f"rmsnorm [{rows}, {d}] "
                                                  f"{dt} pad {pad}: {m}"))
        if not torch.equal(got, again):
            raise AssertionError(f"rmsnorm [{rows}, {d}] {dt} pad {pad}: "
                                 f"two launches differ")
        if dt == torch.float32:
            worst = max(worst, float((got - plain).abs().max()))
        ldx = d + pad if rows > 1 else d
        want.add(rmsnorm.variant(rmsnorm.rmsnorm_plan(
            d, ldx, dt == torch.bfloat16)))
    seen = dict(rmsnorm.rmsnorm.variants)
    if set(seen) != want or not any(v.endswith("scalar") for v in seen):
        raise AssertionError(f"rmsnorm instantiations launched {seen}; the "
                             f"plan names {sorted(want)}")
    log(f"kernel rmsnorm at its plan's edges: {len(cases)} cases (rows "
        f"1-1000, d 4096/12800/4093, bf16, strided rows) within "
        f"rtol=atol=1e-5 (bf16 2e-2), max abs err "
        f"{worst:.3e}; repeats bitwise equal; launches per instantiation "
        f"{seen}")
    return worst


def check_matmul() -> float:
    """Kernel 7 vs its plain version with TF32 off (rtol = atol = 1e-4):
    (512, 512, 512), granite's Wo at 4 rows (4, 4096, 4096) and a ragged
    (100, 300, 70); bf16 in with bf16 and float32 out at 512^3 (5e-2)."""
    from repro_torch.kernels import matmul, ref
    gen = torch.Generator(device="cuda").manual_seed(20)
    worst, n = 0.0, 0
    cases = [((512, 512, 512), torch.float32, None),
             ((4, 4096, 4096), torch.float32, None),
             ((100, 300, 70), torch.float32, None),
             ((512, 512, 512), torch.bfloat16, None),
             ((512, 512, 512), torch.bfloat16, torch.float32)]
    for (m, k, nn), dt, odt in cases:
        x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
        w = (torch.randn((k, nn), generator=gen, device="cuda")
             / k ** 0.5).to(dt)
        got = matmul.matmul(x, w, out_dtype=odt)
        want = ref.matmul_ref(x, w, odt)
        torch.cuda.synchronize()
        tol = 1e-4 if dt == torch.float32 else 5e-2
        torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                                   msg=lambda s: (f"matmul ({m}, {k}, {nn}) "
                                                  f"{dt} -> {odt}: {s}"))
        if dt == torch.float32:
            worst = max(worst, float((got - want).abs().max()))
        n += 1
    log(f"kernel matmul: {n} cases ((512, 512, 512), (4, 4096, 4096), "
        f"ragged (100, 300, 70) at float32 with TF32 off; bf16 in at 512^3) "
        f"within rtol=atol=1e-4 (bf16 5e-2), max abs err {worst:.3e}")
    return worst


def _shards(w: torch.Tensor, t: int) -> torch.Tensor:
    """[(L,) k, m] -> the [(L,) t, k, m/t] column-shard view (no copy)."""
    return w.reshape(w.shape[:-1] + (t, w.shape[-1] // t)).movedim(-2, -3)


def check_encode(cfg) -> float:
    """Kernel 4 vs its plain version (rtol = atol = 1e-5): wq, wk and w1
    stacked over all layers and the head at T=4, r in {1, 2, 3, 4}, both
    layouts; a ragged shape (m_l = 100, k = 1000); T = 2 and T = 8."""
    from repro_torch.core.coding import generator_matrix
    from repro_torch.kernels import cdc_encode as enc
    from repro_torch.models.common import TPCtx
    gen = torch.Generator(device="cuda").manual_seed(15)
    L = cfg.n_layers
    leaves = [("wq", (L, K, T * GEMMS["wq"])), ("wk", (L, K, T * GEMMS["wk"])),
              ("w1", (L, K, T * GEMMS["w1"])),
              ("lm_head", (K, TPCtx(tp=T).pad_dim(cfg.vocab)))]
    cases = [(name, shape, T, r, layout) for name, shape in leaves
             for r in range(1, T + 1) for layout in ("folded", "dedicated")]
    cases += [("ragged", (1000, T * 100), T, 2, "folded"),
              ("ragged", (1000, T * 100), T, 3, "dedicated"),
              ("T=2", (K, 2 * 1024), 2, 1, "dedicated"),
              ("T=8", (K, 8 * 256), 8, 4, "folded")]
    # T=16 (the coded-overhead study's widest code), r = 1..4
    cases += [("T=16", (K, 16 * 256), 16, r, layout) for r in range(1, 5)
              for layout in ("folded", "dedicated")]
    worst, w, current = 0.0, None, None
    for name, shape, t, r, layout in cases:
        if current != (name, shape):
            w = None                       # free the previous leaf first
            w = torch.randn(shape, generator=gen, device="cuda")
            current = (name, shape)
        sh = _shards(w, t)
        g = generator_matrix(t, r)
        got = enc.cdc_encode(sh, g, layout=layout)
        want = enc.encode_plain(sh, g, layout)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: (
                                       f"encode {name} {tuple(shape)} T={t} "
                                       f"r={r} {layout}: {m}"))
        worst = max(worst, float((got - want).abs().max()))
        del got, want
    del w, sh
    torch.cuda.empty_cache()
    log(f"kernel cdc_encode: {len(cases)} cases (wq, wk, w1 stacked over "
        f"{L} layers and the head at T=4, r=1..4, both layouts; ragged "
        f"m_l=100, k=1000; T=2; T=8; T=16 at r=1..4, both layouts) within "
        f"rtol=atol=1e-5 of the plain version, max abs err {worst:.3e}")
    return worst


def check_encode_bf16(cfg) -> tuple[float, float]:
    """Kernel 4 on bf16 shards (bf16 parity, float32 math) against its
    plain version within 2e-2: the whole stacked encode of granite-3-8b
    at T = 4, r = 2 folded (wq, wk, wv, w1, w3 over all layers and the
    head), each leaf encoded twice to the same bits; the dedicated layout,
    a ragged shape (the scalar path) and T = 16 at r = 2. Unit-scale
    N(0, 1) weights, as the CPU test of the plain version holds them:
    parities of typical size 1-4, so rtol = atol = 2e-2 is a few bf16
    steps and a shard dropped from a parity row (an error of ~0.25 or
    more) fails.
    Returns (max abs err, max |parity|)."""
    from repro_torch.core.coding import generator_matrix
    from repro_torch.kernels import cdc_encode as enc
    from repro_torch.models.common import TPCtx
    gen = torch.Generator(device="cuda").manual_seed(29)
    L = cfg.n_layers
    leaves = [(n, (L, K, T * GEMMS[n]), T, R, "folded") for n in GEMMS]
    leaves += [("lm_head", (K, TPCtx(tp=T).pad_dim(cfg.vocab)), T, R,
                "folded"),
               ("wq", (L, K, T * GEMMS["wq"]), T, 3, "dedicated"),
               ("ragged", (1000, T * 100), T, 2, "folded"),
               ("T=16", (K, 16 * 256), 16, 2, "folded")]
    worst = scale = 0.0
    for name, shape, t, r, layout in leaves:
        w = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        sh = _shards(w, t)
        g = generator_matrix(t, r)
        got = enc.cdc_encode(sh, g, layout=layout)
        again = enc.cdc_encode(sh, g, layout=layout)
        want = enc.encode_plain(sh, g, layout)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16 or not torch.equal(got, again):
            raise AssertionError(f"bf16 encode {name}: dtype {got.dtype}, "
                                 f"repeat equal {torch.equal(got, again)}")
        torch.testing.assert_close(got, want, **BF16_TOL, msg=lambda m: (
            f"bf16 encode {name} {shape} T={t} r={r} {layout}: {m}"))
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        scale = max(scale, float(want.float().abs().max()))
        del w, sh, got, again, want
    torch.cuda.empty_cache()
    log(f"kernel cdc_encode on bf16: {len(leaves)} leaves (granite's whole "
        f"stacked encode at T=4, r=2 folded; dedicated; ragged; T=16) within "
        f"rtol=atol=2e-2 of the plain version at N(0, 1) weights (max "
        f"|parity| {scale:.3f}), max abs err {worst:.3e}; every leaf "
        f"encoded twice to the same bits")
    return worst, scale


def _phase_memory(name: str):
    log(f"{name}: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


# ------------------------------------------------------------ phase 3 ----

def norms_per_pass(cfg) -> int:
    """RMSNorm launches of one model pass (a decode round or a prefill):
    two per layer and the final norm."""
    return 2 * cfg.n_layers + 1


N_TOK = 16


def serve_batch(vocab: int) -> dict:
    """The served requests: 4 prompts of 16 tokens, seeded."""
    return {"tokens": np.random.default_rng(0).integers(0, vocab, (4, 16))}


def _serve_run(eng, batch, fail_at=None, n_tok: int = N_TOK) -> dict:
    """One ServingEngine.generate of the 4 requests (n_tok new tokens),
    with the launch counts of kernels 1, 2 and 6 read around it (a
    replayed graph's launches are credited to the counts) and VStep's
    round counters over the run."""
    from repro_torch.kernels import cdc_decode, cdc_matmul, rmsnorm
    counted = (cdc_matmul.cdc_coded_matmul,
               cdc_decode.cdc_fused_head_argmax, rmsnorm.rmsnorm)
    for fn in counted:
        fn.launches = 0
        fn.variants.clear()
    vs = eng.executor(4).vstep
    before = {k: getattr(vs, k) for k in VSTEP_COUNTERS}
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks = eng.generate(batch, n_tok, fail_at=fail_at)
    torch.cuda.synchronize()
    ex = eng.executor(4)
    out = {"tokens": toks, "seconds": time.perf_counter() - t,
           "round_ms": list(ex.round_ms[-(n_tok - 1):]),
           "variants": ex.vstep.last_variant, "graphs": vs.use_graphs,
           "vstep": {k: getattr(vs, k) - before[k]
                     for k in VSTEP_COUNTERS}}
    for key, fn in zip(("k1", "k2", "k6"), counted):
        out[key] = fn.launches
        out[f"{key}_variants"] = dict(fn.variants)
    return out


VSTEP_COUNTERS = ("n_dispatches", "n_fused_rounds", "n_captures",
                  "n_replays", "n_graph_drops")


def _check_graph_run(name: str, res: dict, captures: int):
    """A run on graph rounds: one replay per fused round, every round
    fused, and at most ``captures`` new graphs (one per new mask)."""
    c = res["vstep"]
    if not res["graphs"] or c["n_replays"] != c["n_fused_rounds"] \
            or c["n_fused_rounds"] != c["n_dispatches"] \
            or c["n_captures"] > captures:
        raise AssertionError(f"{name}: graph counters {c} (want a replay "
                             f"per fused round, <= {captures} captures)")


def _check_eager_run(name: str, res: dict):
    c = res["vstep"]
    if res["graphs"] or c["n_replays"] or c["n_captures"]:
        raise AssertionError(f"{name}: an eager run captured or replayed: "
                             f"{c}")


def serve_full_width(cfg) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.models import TPCtx, build, transformer
    from repro_torch.serve import ServeConfig, ServingEngine
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R))
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    log(f"granite-3-8b full width: params initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    scfg = ServeConfig(max_len=16 + 16 + 8, batch=4,
                       cache_dtype=torch.float32)
    batch = serve_batch(cfg.vocab)
    n_tok = N_TOK

    def run(eng, fail_at=None):
        return _serve_run(eng, batch, fail_at)

    torch.cuda.reset_peak_memory_stats()
    # fused rounds replay captured CUDA graphs (the default on the card)
    eng = ServingEngine(model, params, scfg, use_fused=True,
                        use_graphs=True)
    clean = run(eng)
    _check_graph_run("fault-free", clean, 1)
    graph_eager = graph_vs_eager(eng, batch, clean)
    overlapped = run_overlapped(eng.stepper, batch, n_tok)
    if not np.array_equal(overlapped["tokens"], clean["tokens"]):
        raise AssertionError("overlapped executor tokens differ:\n"
                             f"{overlapped['tokens']}\nvs\n{clean['tokens']}")
    faulty = run(eng, fail_at={4: 2})      # a second graph: shard 2 dead
    _check_graph_run("erasure", faulty, 1)
    eng.valid = np.ones(T, bool)
    eng.use_graphs = False
    faulty_eager = run(eng, fail_at={4: 2})
    _check_eager_run("eager erasure", faulty_eager)
    if not np.array_equal(faulty_eager["tokens"], faulty["tokens"]):
        raise AssertionError("eager and graph rounds differ with shard 2 "
                             f"erased:\n{faulty_eager['tokens']}\nvs\n"
                             f"{faulty['tokens']}")
    eng.use_graphs = True
    vs = eng.executor(4).vstep
    graph_counts = {k: getattr(vs, k) for k in VSTEP_COUNTERS}
    del eng, vs
    ref_eng = ServingEngine(model, params, scfg, use_fused=False)
    reference = run(ref_eng)
    # the same reference variant with the norms on their plain version (the
    # model resolves ``rmsnorm`` in the transformer module): a run with no
    # kernel at all, the oracle for the fused tokens
    norm = transformer.rmsnorm
    transformer.rmsnorm = lambda p, x, eps: ref.rmsnorm_ref(x, p["g"], eps)
    try:
        plain = run(ref_eng)
    finally:
        transformer.rmsnorm = norm
    del ref_eng
    peak = torch.cuda.max_memory_allocated()
    rounds = n_tok - 1
    gemms = 5 * cfg.n_layers          # wq, wk, wv, w1, w3 in every layer
    for name, res in (("fault-free", clean), ("shard 2 dead at step 4",
                                              faulty)):
        if res["k1"] != gemms * rounds or res["k2"] != rounds:
            raise AssertionError(
                f"{name}: {res['k1']} coded-GEMM and {res['k2']} head "
                f"launches over {rounds} fused rounds; expected "
                f"{gemms * rounds} and {rounds}")
    if reference["k1"] or reference["k2"]:
        raise AssertionError("the reference variant launched a kernel")
    # granite's GEMMs and head are aligned: every launch takes the copy
    # engine, and the head's 4 rows one block of 4 rows each
    for name, res in (("fault-free", clean), ("erasure", faulty)):
        if not all(v.endswith("-async") for v in res["k1_variants"]):
            raise AssertionError(f"{name}: coded-GEMM instantiations "
                                 f"{res['k1_variants']}; want only -async")
        if res["k2_variants"] != {"rb4-async": rounds}:
            raise AssertionError(f"{name}: fused-head instantiations "
                                 f"{res['k2_variants']}; want rb4-async "
                                 f"x {rounds}")
    if plain["k1"] or plain["k2"] or plain["k6"]:
        raise AssertionError(
            f"the kernel-free run launched {plain['k1']} coded-GEMM, "
            f"{plain['k2']} head and {plain['k6']} rmsnorm kernels")
    # every round and every prefill (one per request) runs its norms
    # through kernel 6, in the fused and the reference variant alike
    norms = norms_per_pass(cfg)
    for name, res in (("fault-free", clean), ("erasure", faulty),
                      ("reference", reference)):
        if res["k6"] != norms * (rounds + 4):
            raise AssertionError(
                f"{name}: {res['k6']} rmsnorm launches; expected {norms} "
                f"per round x {rounds} rounds + {norms} per prefill x 4")
    for name, res in (("erasure", faulty), ("reference", reference),
                      ("kernel-free", plain)):
        if not np.array_equal(res["tokens"], clean["tokens"]):
            raise AssertionError(
                f"{name} run tokens differ from the fault-free fused run:\n"
                f"{res['tokens']}\nvs\n{clean['tokens']}")
    toks = clean["tokens"]
    if toks.shape != (4, n_tok) or toks.min() < 0 or toks.max() >= cfg.vocab:
        raise AssertionError(f"bad token stream {toks}")
    med = float(np.median(clean["round_ms"]))
    log(f"served 4 requests x {n_tok} tokens: identical streams fault-free, "
        f"with shard 2 erased at step 4, on the reference variant, and on "
        f"it with plain norms (no kernel launched)")
    log("first stream:", toks[0].tolist())
    log(f"overlapped executor (dispatch N, then harvest N-1): same "
        f"streams, {overlapped['period_ms']:.3f} ms per round (wall time "
        f"of {n_tok} steps / {n_tok})")
    log(f"launches per fused round: {clean['k1'] // rounds} coded-GEMM "
        f"({clean['k1_variants']}) + "
        f"{clean['k2'] // rounds} fused head ({clean['k2_variants']}) + "
        f"{norms} rmsnorm ({clean['k6_variants']}; and {norms} rmsnorm per "
        f"prefill; the reference variant {norms} per round)")
    log(f"graph rounds: {graph_counts['n_captures']} captures (fault-free, "
        f"shard 2 dead), {graph_counts['n_replays']} replays for "
        f"{graph_counts['n_fused_rounds']} fused rounds; tokens equal to "
        f"eager fused rounds fault-free and with shard 2 erased")
    log(f"fused round median {med:.3f} ms (erasure run "
        f"{float(np.median(faulty['round_ms'])):.3f} ms, reference variant "
        f"{float(np.median(reference['round_ms'])):.3f} ms, with plain "
        f"norms {float(np.median(plain['round_ms'])):.3f} ms); "
        f"{4 * 1e3 / med:.1f} tokens/s at 4 slots; "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB")
    return {"k1": clean["k1"], "k2": clean["k2"], "k6": clean["k6"],
            "breakdown": graph_eager["breakdown"],
            "graph_vs_eager": graph_eager}


def graph_vs_eager(eng, batch, first: dict, blocks: int = 3) -> dict:
    """Round time of graph-replayed and eager fused rounds in alternating
    blocks (eager, graph, eager, graph, ...; ``first``, a graph run, is
    the first graph block), each block one generate of the 4 requests with
    tokens identical to ``first``'s; then the profiler's device time over
    3 more rounds of each. Leaves the engine on graph rounds."""
    runs = {True: [first], False: []}
    for i in range(2 * blocks - 1):
        eng.use_graphs = i % 2 == 1
        res = _serve_run(eng, batch)
        if eng.use_graphs:
            _check_graph_run(f"block {i + 1}", res, 0)
        else:
            _check_eager_run(f"block {i + 1}", res)
        if not np.array_equal(res["tokens"], first["tokens"]):
            raise AssertionError(f"{'graph' if eng.use_graphs else 'eager'}"
                                 f" block {i + 1} tokens differ:\n"
                                 f"{res['tokens']}\nvs\n{first['tokens']}")
        runs[eng.use_graphs].append(res)
    out = {}
    for graphs, name in ((False, "eager"), (True, "graph")):
        eng.use_graphs = graphs
        ms = [x for r in runs[graphs] for x in r["round_ms"]]
        med = float(np.median(ms))
        log(f"{name} fused rounds ({len(runs[graphs])} blocks, {len(ms)} "
            f"rounds): median {med:.3f} ms, block medians "
            f"{[round(float(np.median(r['round_ms'])), 3) for r in runs[graphs]]}")
        prof = profile_rounds(eng.executor(4), eng.valid, med)
        out[name] = {"round_ms_median": med, "rounds": len(ms),
                     "block_medians": [float(np.median(r["round_ms"]))
                                       for r in runs[graphs]],
                     "device_ms": prof.get("device_ms"),
                     "idle_share": (1 - prof["device_ms"] / med
                                    if prof else None),
                     "profile": prof}
    out["breakdown"] = out["eager"]["profile"]
    log(f"graph vs eager (same call, alternating blocks): round median "
        f"{out['graph']['round_ms_median']:.3f} vs "
        f"{out['eager']['round_ms_median']:.3f} ms, device busy "
        f"{out['graph']['device_ms']} vs {out['eager']['device_ms']} ms, "
        f"idle share {out['graph']['idle_share']} vs "
        f"{out['eager']['idle_share']}")
    return out


def run_overlapped(stepper, batch, n_tok: int) -> dict:
    """The same requests through a pipelined executor (overlap=True): each
    step dispatches round N and harvests round N-1 through its pinned
    host copy and CUDA event."""
    from repro_torch.runtime.executor import SlotPoolExecutor
    ex = SlotPoolExecutor(stepper, 4, overlap=True, use_fused=True)
    valid = np.ones(T, bool)
    toks = np.zeros((4, n_tok), np.int64)
    filled = [1] * 4
    for i in range(4):
        toks[i, 0] = ex.admit(i, batch["tokens"][i], valid, tag=i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_tok):          # the last step only drains the pipe
        for slot, tag, tok in ex.step_round(valid):
            if filled[slot] < n_tok:
                toks[slot, filled[slot]] = tok
                filled[slot] += 1
    ex.drop_pending()
    torch.cuda.synchronize()
    return {"tokens": toks,
            "period_ms": (time.perf_counter() - t0) * 1e3 / n_tok}


def profile_rounds(ex, valid, round_ms: float, n: int = 3) -> dict:
    """Device time of ``n`` more fused rounds by kernel, from
    torch.profiler, against the unprofiled median round time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            ex.step_round(valid)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count // n)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms == 0:
        log("profiler: no device time recorded; breakdown not measured")
        return {}
    log(f"profiler, per fused round: device busy {device_ms:.3f} ms of a "
        f"{round_ms:.3f} ms round (idle share "
        f"{1 - device_ms / round_ms:.3f}); by kernel:")
    for key, ms, count in rows[:10]:
        log(f"  {ms:8.3f} ms  x{count:<4d} {key[:90]}")
    per_launch = {name: (ms, count) for key, ms, count in rows
                  for name in ("rmsnorm_kernel", "head_stream_kernel")
                  if name in key}
    for name, (ms, count) in per_launch.items():
        log(f"  {name}: {ms * 1e3 / max(count, 1):.3f} us a launch "
            f"({count} a round)")
    return {"device_ms": device_ms, "round_ms": round_ms,
            "top": [{"kernel": k[:90], "ms": ms, "count": c}
                    for k, ms, c in rows[:10]],
            "us_per_launch": {n: ms * 1e3 / max(c, 1)
                              for n, (ms, c) in per_launch.items()}}


# ------------------------------------------------------------ phase 4 ----

def _time(fn, flush, n=30) -> float:
    """Median device ms of ``fn`` over n calls, each timed by CUDA events.
    Before each call ``flush`` evicts the weights from L2 (the main path
    finds them cold), and a spin kernel holds the stream while the host
    enqueues the call, so the events time the device work and not the
    host's launch overhead."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _profile_us(fn, name: str, n: int = 200) -> float:
    """Device microseconds a call of ``fn`` spends in the kernels whose
    name holds ``name`` (every kernel for ""), by torch.profiler over n
    calls, back to back, the inputs left where the last call left them."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and name in e.key)
    if not us:
        raise AssertionError(f"the profiler recorded no device time for "
                             f"{name!r}")
    return us / n


def _bound(bytes_moved: float, flops: float,
           peak: float = F32_FLOPS) -> tuple[float, str]:
    t_b, t_o = bytes_moved / HBM_BYTES_PER_S, flops / peak
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


PTXAS: dict[str, str] = {}     # kernel entry -> ptxas usage (phase 1)


def _usage(entry: str, rb: int | None = None) -> str:
    """ptxas's registers and static shared memory of the first kernel
    entry containing ``entry``, and, for a streaming kernel with ``rb``
    rows a block, its dynamic shared memory (stream_tile.cuh's Geo<RB>:
    the ring, the staged activations, the row statistics, the barriers)."""
    line = next((v for k, v in PTXAS.items() if entry in k),
                "ptxas usage not recorded (kernels not rebuilt)")
    if rb is not None:
        from repro_torch.kernels import stream_plan as sp
        dyn = (sp.NSTAGE[rb] * sp.STAGE_FLOATS + sp.XS_FLOATS[rb] + 16) * 4 \
            + 2 * sp.NSTAGE[rb] * 8
        line += f", {dyn} bytes dynamic smem"
    return line


def time_kernels(cfg, rows: int = 4) -> list[dict]:
    from repro_torch.core.coded_layer import unfold_parity
    from repro_torch.kernels import cdc_decode, cdc_matmul, ref
    gen = torch.Generator(device="cuda").manual_seed(13)
    scratch = torch.empty(64 * 2 ** 20, device="cuda")   # 256 MB > L2
    flush = scratch.zero_
    out = []
    # r=2 is the main path's geometry; w1 at r=4 is the planner's; 64 rows
    # is a prefill's
    for rws, name, m_l, r in [(rw, n, m, rr) for rw in (rows, 64)
                              for n, m, rr in (("w1", 3200, R),
                                               ("wq", 1024, R),
                                               ("wk", 256, R),
                                               ("w1", 3200, 4))]:
        spec, x, w, wc = _coded_case(m_l, rws, "folded", gen, r=r)
        valid = (True,) * T
        wcat = torch.cat([w, unfold_parity(wc, T, r).permute(1, 0, 2)
                          .reshape(K, r * m_l)], dim=1)
        cdc_matmul.cdc_coded_matmul.variants.clear()
        ms = _time(lambda: _run_coded(x, w, wc, spec, valid), flush)
        if not out:
            # the phase's first reading ran ~12% above kernel_times.py's
            # at the same shape: timed again, both logged
            first, ms = ms, _time(lambda: _run_coded(x, w, wc, spec, valid),
                                  flush)
            log(f"cdc_coded_matmul {name} [rows={rws}, T={T}, r={r}]: the "
                f"phase's first reading {first:.4f} ms, then {ms:.4f} ms")
        variant, = cdc_matmul.cdc_coded_matmul.variants
        plain = _time(lambda: _run_coded(x, w, wc, spec, valid, plain=True),
                      flush)
        lib = _time(lambda: torch.matmul(x, wcat), flush)
        nbytes = 4 * (rws * K + (T + r) * K * m_l + rws * T * m_l
                      + 2 * m_l)
        bound, by = _bound(nbytes, 2.0 * rws * K * m_l * (T + r))
        rb = int(variant.split("-")[0][2:])
        usage = _usage(f"coded_stream_kernelILi{T}ELi{r}ELi{rb}ELb"
                       f"{int(variant.endswith('async'))}E", rb)
        out.append({"gemm": name, "r": r, "rows": rws, "m_l": m_l,
                    "ms": ms, "plain_ms": plain, "library_ms": lib,
                    "bound_ms": bound, "bound_by": by, "variant": variant,
                    "ptxas": usage})
        log(f"cdc_coded_matmul {name} [rows={rws}, k={K}, m_l={m_l}, "
            f"T={T}, r={r}]: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"library matmul {lib:.4f} ms, bound {bound:.4f} ms ({by}); "
            f"{variant}: {usage}")
        del x, w, wc, wcat
    w = _head(cfg, gen)
    w_shards, pw = _head_views(w)
    m_l = w_shards.shape[2]
    wcat = torch.cat([w, pw], dim=1)
    valid = (True,) * T
    vt = torch.tensor(valid)
    # the decode round's rows, and 16 (four times the slots)
    for rws in (rows, 16):
        x = torch.randn((rws, K), generator=gen, device="cuda")
        cdc_decode.cdc_fused_head_argmax.variants.clear()
        ms = _time(lambda: cdc_decode.cdc_fused_head_argmax(
            x, w_shards, pw, valid, vocab=cfg.vocab), flush)
        variant, = cdc_decode.cdc_fused_head_argmax.variants
        plain = _time(lambda: ref.fused_head_argmax_ref(x, w_shards, pw, vt,
                                                        cfg.vocab), flush)
        lib = _time(lambda: torch.matmul(x, wcat), flush)
        nbytes = 4 * (rws * K + (T + 1) * K * m_l + 2 * rws)
        bound, by = _bound(nbytes, 2.0 * rws * K * m_l * (T + 1))
        rb = int(variant.split("-")[0][2:])
        usage = _usage(f"head_stream_kernelILi{T}ELi{rb}ELb"
                       f"{int(variant.endswith('async'))}E", rb)
        out.append({"gemm": "lm_head", "rows": rws, "m_l": m_l, "ms": ms,
                    "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                    "bound_by": by, "variant": variant, "ptxas": usage})
        log(f"cdc_fused_head_argmax [b={rws}, k={K}, m_l={m_l}]: kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, library matmul {lib:.4f} "
            f"ms, bound {bound:.4f} ms ({by}); {variant}: {usage}")
    del w, w_shards, pw, wcat
    out += time_wide_and_bf16(cfg, gen, flush, rows)
    out += time_small_kernels(gen, flush)
    return out


def time_wide_and_bf16(cfg, gen, flush, rows: int = 4) -> list[dict]:
    """Kernels 1 and 2 on bf16 storage at T = 4 and in float32 at T = 16,
    at the decode round's rows: kernel 1 at granite's w1 (r = 2 and 4), wq
    and wk (r = 2), folded (``kernel_times.WIDE_AND_BF16``, the shapes
    ``kernel_times.py --new`` times), kernel 2 at its head; beside their
    plain versions and one torch.matmul of x over the same weights,
    concatenated, in their storage type. Bounds: the bytes in their
    storage type, or the FLOPs at the type's peak (bf16: the tensor
    cores')."""
    from kernel_times import WIDE_AND_BF16
    from repro_torch.core.coded_layer import unfold_parity
    from repro_torch.kernels import cdc_decode, cdc_matmul, ref
    from repro_torch.models.common import TPCtx
    out = []
    for t, dtype, gemms in WIDE_AND_BF16:
        e = 2 if dtype == torch.bfloat16 else 4
        peak = BF16_FLOPS if e == 2 else F32_FLOPS
        tag = f"T={t} {str(dtype).split('.')[-1]}"
        for name, width, r in gemms:
            m_l = width // t
            spec, x, w, wc = _coded_case(m_l, rows, "folded", gen, r=r, t=t,
                                         dtype=dtype)
            valid = (True,) * t
            wcat = torch.cat([w, unfold_parity(wc, t, r).permute(1, 0, 2)
                              .reshape(K, r * m_l)], dim=1)
            cdc_matmul.cdc_coded_matmul.variants.clear()
            ms = _time(lambda: _run_coded(x, w, wc, spec, valid), flush)
            variant, = cdc_matmul.cdc_coded_matmul.variants
            plain = _time(lambda: _run_coded(x, w, wc, spec, valid,
                                             plain=True), flush)
            lib = _time(lambda: torch.matmul(x, wcat), flush)
            bound, by = _bound(e * (rows * K + (t + r) * K * m_l
                                    + rows * t * m_l) + 8.0 * m_l,
                               2.0 * rows * K * m_l * (t + r), peak)
            out.append({"gemm": name, "r": r, "rows": rows, "m_l": m_l,
                        "case": tag, "ms": ms, "plain_ms": plain,
                        "library_ms": lib, "bound_ms": bound,
                        "bound_by": by, "variant": variant})
            log(f"cdc_coded_matmul {name} {tag} [rows={rows}, k={K}, "
                f"m_l={m_l}, r={r} folded]: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, library matmul {lib:.4f} ms, bound "
                f"{bound:.4f} ms ({by}); {variant}")
            del x, w, wc, wcat
        m = TPCtx(tp=t).pad_dim(cfg.vocab)
        w = (torch.randn((K, m), generator=gen, device="cuda")
             / K ** 0.5).to(dtype)
        w_shards, pw = _head_views(w, t)
        m_l = w_shards.shape[2]
        wcat = torch.cat([w, pw], dim=1)
        x = torch.randn((rows, K), generator=gen, device="cuda")
        vt = torch.tensor((True,) * t)
        cdc_decode.cdc_fused_head_argmax.variants.clear()
        ms = _time(lambda: cdc_decode.cdc_fused_head_argmax(
            x, w_shards, pw, (True,) * t, vocab=cfg.vocab), flush)
        variant, = cdc_decode.cdc_fused_head_argmax.variants
        plain = _time(lambda: ref.fused_head_argmax_ref(
            x, w_shards, pw, vt, cfg.vocab), flush)
        xl = x.to(dtype)
        lib = _time(lambda: torch.matmul(xl, wcat), flush)
        bound, by = _bound(4.0 * rows * K + e * (t + 1) * K * m_l
                           + 8.0 * rows, 2.0 * rows * K * m_l * (t + 1),
                           peak)
        out.append({"gemm": "lm_head", "rows": rows, "m_l": m_l,
                    "case": tag, "ms": ms, "plain_ms": plain,
                    "library_ms": lib, "bound_ms": bound, "bound_by": by,
                    "variant": variant})
        log(f"cdc_fused_head_argmax {tag} [b={rows}, k={K}, m_l={m_l}]: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library matmul "
            f"{lib:.4f} ms, bound {bound:.4f} ms ({by}); {variant}")
        del w, w_shards, pw, wcat
    return out


def _row(out: list, kernel: str, shape: str, ms: float, plain: float,
         lib: float | None, nbytes: float, flops: float):
    bound, by = _bound(nbytes, flops)
    out.append({"kernel": kernel, "shape": shape, "ms": ms,
                "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                "bound_by": by})
    log(f"{kernel} {shape}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"library {'none' if lib is None else f'{lib:.4f} ms'}, bound "
        f"{bound:.4f} ms ({by})")


def time_small_kernels(gen, flush) -> list[dict]:
    """Kernels 3, 5, 6 and 7 at the shapes of their paths: the decode +
    merge at granite w1 (T=4, r=2 folded, shard 2 dead), the r=1 decode
    at the study's shape and at w1's, the norm at the serving round's 4
    and a prefill's 64 rows, the GEMM at the study's 512^3 and at
    granite's Wo with 4 rows. Bounds count the bytes these inputs need:
    the decodes read the live shards and the one selected parity (kernel
    3) or every shard and the parity (kernel 5)."""
    import torch.nn.functional as F
    from repro_torch.core.coded_layer import CodedDenseSpec
    from repro_torch.core.coding import CodeSpec
    from repro_torch.kernels import (cdc_decode, cdc_matmul, matmul, ref,
                                     rmsnorm)
    out: list[dict] = []
    spec = CodedDenseSpec(CodeSpec(T, R))
    m_l = GEMMS["w1"]
    dead2 = (True, True, False, True)
    floor_us = _profile_us(lambda: torch.cuda._sleep(0), "")
    log(f"an empty kernel (torch.cuda._sleep(0)): {floor_us:.3f} us of "
        f"device time a launch by the profiler (the launch floor)")
    for rows, valid in ((4, dead2), (64, dead2), (2048, dead2),
                        (2048, (True,) * T)):
        vh, esel, coef, g = _dm_plan(spec, valid, m_l)
        ys = torch.randn((T, rows, m_l), generator=gen, device="cuda")
        par = torch.randn((T, rows, R * m_l // T), generator=gen,
                          device="cuda")
        call = (ys, par, "folded", T, R, g, esel, coef, vh)
        ms = _time(lambda: cdc_matmul.cdc_decode_merge(*call), flush)
        plain = _time(lambda: cdc_matmul.decode_merge_plain(*call), flush)
        dead = not all(valid)
        _row(out, "cdc_decode_merge", f"[{T}, {rows}, {m_l}] r={R} folded"
             + ("" if dead else " all valid"), ms, plain, None,
             4.0 * (2 * T * rows * m_l) + (8.0 * m_l if dead else 0.0),
             rows * m_l * (2.0 * T + 2) if dead else 0.0)
        out[-1].update(profiler_us=_profile_us(
            lambda: cdc_matmul.cdc_decode_merge(*call), "decode_merge"),
            floor_us=floor_us)
        del ys, par
    for t, shape in ((8, (256, 512)), (4, (4, 3200)), (4, (2048, 3200))):
        y = torch.randn((t,) + shape, generator=gen, device="cuda")
        p = y.sum(0)
        valid = tuple(i != t // 2 for i in range(t))
        vt = torch.tensor(valid, device="cuda")
        n = p.numel()
        ms = _time(lambda: cdc_decode.cdc_decode(y, p, valid), flush)
        plain = _time(lambda: ref.cdc_decode_ref(y, p, vt), flush)
        _row(out, "cdc_decode", str([t, *shape]), ms, plain, None,
             4.0 * (2 * t + 1) * n, n * (3.0 * t + 1))
        out[-1].update(profiler_us=_profile_us(
            lambda: cdc_decode.cdc_decode(y, p, valid), "decode_kernel"),
            floor_us=floor_us)
        del y, p
    for row in out:
        log(f"  {row['kernel']} {row['shape']}: {row['profiler_us']:.3f} us "
            f"a launch by the profiler (bound {row['bound_ms'] * 1e3:.3f} "
            f"us, {row['bound_ms'] * 1e3 / row['profiler_us']:.0%} of it; "
            f"floor {floor_us:.3f} us)")
    gam = 1.0 + 0.1 * torch.randn(K, generator=gen, device="cuda")
    for rows in (4, 64):
        x = torch.randn((rows, K), generator=gen, device="cuda")
        rmsnorm.rmsnorm.variants.clear()
        ms = _time(lambda: rmsnorm.rmsnorm(x, gam, eps=1e-5), flush)
        variant, = rmsnorm.rmsnorm.variants
        plain = _time(lambda: ref.rmsnorm_ref(x, gam, 1e-5), flush)
        lib = _time(lambda: F.rms_norm(x, (K,), gam, 1e-5), flush)
        _row(out, "rmsnorm", f"[{rows}, {K}]", ms, plain, lib,
             4.0 * (2 * rows * K + K), 4.0 * rows * K)
        nv = 0 if variant == "scalar" else int(variant[2:])
        usage = _usage(f"rmsnorm_kernelIfLi{nv}EE")
        out[-1].update(variant=variant, ptxas=usage)
        log(f"  rmsnorm {variant}: {usage}")
    for m, k, n in ((512, 512, 512), (4, K, K)):
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
        matmul.matmul.variants.clear()
        ms = _time(lambda: matmul.matmul(x, w), flush)
        variant, = matmul.matmul.variants
        plain = _time(lambda: ref.matmul_ref(x, w), flush)
        lib = _time(lambda: torch.matmul(x, w), flush)
        a = int(variant.endswith("async"))
        rb = None if variant.startswith("square") else \
            int(variant.split("-")[1][2:])
        usage = (_usage(f"matmul_square_kernelIffLb{a}E") if rb is None else
                 _usage(f"matmul_rows_kernelILi{rb}EfLb{a}E", rb))
        _row(out, "matmul", f"[{m}, {k}] @ [{k}, {n}]", ms, plain, lib,
             4.0 * (m * k + k * n + m * n), 2.0 * m * k * n)
        out[-1].update(variant=variant, ptxas=usage)
        log(f"  matmul {variant}: {usage}")
    return out


# ------------------------------------------------------- phase 6 ----

def run_study(device: str = "cuda") -> dict:
    """The paper's coded-cost study through its port
    (``launch.coded_overhead``), at the reference's defaults: ``run``
    (T in {4, 8, 16} x r in {1, 2} folded, the encode kernel at T = 16
    included) and ``run_kernels`` (kernels 5 and 7). The counts are read
    around the two calls. The coded outputs are checked against x @ w:
    exact to 1e-4 with every shard alive, and with shard 1 dead at r = 2;
    at r = 1 folded (no device failure in budget) the 'recovering' output
    is beyond the budget, in this port as in the reference, and only its
    distance from x @ w is reported."""
    from repro_torch.launch import coded_overhead as study
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    wrappers["matmul"].variants.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = study.run(device=device)
    krows = study.run_kernels(device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    for name in ("cdc_decode", "matmul", "cdc_encode"):
        if not launches[name]:
            raise AssertionError(f"the study launched no {name}: {launches}")
    mm_variants = dict(wrappers["matmul"].variants)
    if set(mm_variants) != {"square-async"}:
        raise AssertionError(f"the study's 512^3 GEMM took {mm_variants}")
    if [(r["T"], r["r"]) for r in rows] != [(t, r) for t in (4, 8, 16)
                                            for r in (1, 2)]:
        raise AssertionError(f"study sweep {rows}")
    errs = {}
    for c in study.study_cases(device=device):
        exact = c.x @ c.w
        coded = float((c.coded(c.x) - exact).abs().max())
        rec = float((c.recovering(c.x) - exact).abs().max())
        if coded > 1e-4 or (c.r == 2 and rec > 1e-4):
            raise AssertionError(f"study T={c.T} r={c.r}: coded err {coded}"
                                 f", recovering err {rec}")
        errs[f"T={c.T},r={c.r}"] = {"coded": coded, "recovering": rec}
    log(f"coded-overhead study on the card ({secs:.1f} s, launches "
        f"{launches}; GEMM instantiations {mm_variants}):")
    for r in rows + krows:
        log(f"  {r}")
    log("  max |out - x @ w|: " + "; ".join(
        f"{k} coded {v['coded']:.2e} recovering {v['recovering']:.2e}"
        for k, v in errs.items()) + " (r=1 folded with shard 1 dead is "
        "beyond the budget)")
    return {"run": rows, "kernels": krows, "launches": launches,
            "errors": errs}


def decode_merge_entry() -> dict:
    """``core.decode_and_merge(use_fused=True)``, kernel 3's library entry,
    on a coded GEMM's own shard and parity outputs at granite's w1 and wq
    widths (4 rows, T=4, r=2 folded), each shard dead in turn with NaN
    outputs: it must rebuild x @ w, equal the reference decode_and_merge
    to 1e-5 and launch kernel 3 once per call."""
    from repro_torch.core.coded_layer import decode_and_merge
    from repro_torch.kernels import cdc_matmul
    gen = torch.Generator(device="cuda").manual_seed(21)
    cdc_matmul.cdc_decode_merge.launches = 0
    n, worst = 0, 0.0
    for m_l in (GEMMS["w1"], GEMMS["wq"]):
        spec, x, w, wc = _coded_case(m_l, 4, "folded", gen)
        exact = x @ w
        ys = exact.reshape(4, T, m_l).movedim(1, 0).contiguous()
        par = torch.matmul(x[None], wc)
        for valid in _masks():
            yd = ys.clone()
            for d in range(T):
                if not valid[d]:
                    yd[d] = float("nan")
            v = np.array(valid)
            got = decode_and_merge(yd, par, spec, v, use_fused=True)
            want = decode_and_merge(yd, par, spec, v)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(got, exact, rtol=1e-4, atol=1e-4)
            worst = max(worst, float((got - want).abs().max()))
            n += 1
    launches = cdc_matmul.cdc_decode_merge.launches
    if launches != n:
        raise AssertionError(f"{launches} decode-merge launches for {n} "
                             f"calls of decode_and_merge(use_fused=True)")
    log(f"decode_and_merge(use_fused=True): {n} calls (w1, wq; every "
        f"single dead shard) launched kernel 3 {launches} times, equal to "
        f"the reference decode_and_merge within 1e-5 (max abs err "
        f"{worst:.3e}) and to x @ w within 1e-4")
    return {"launches": launches, "max_abs_err": worst}


# ------------------------------------------------------- phases 8, 9 ----

def _check_launches(name: str, res: dict, cfg, rounds: int, norms: bool):
    """Every fused round: kernel 1 for wq, wk, wv, w1, w3 of every layer,
    kernel 2 once; with ``norms``, kernel 6 for every round and prefill."""
    gemms = 5 * cfg.n_layers
    if res["k1"] != gemms * rounds or res["k2"] != rounds:
        raise AssertionError(f"{name}: {res['k1']} coded-GEMM and "
                             f"{res['k2']} head launches over {rounds} fused "
                             f"rounds; expected {gemms * rounds} and "
                             f"{rounds}")
    if norms and res["k6"] != norms_per_pass(cfg) * (rounds + 4):
        raise AssertionError(f"{name}: {res['k6']} rmsnorm launches")


def serve_t16(cfg) -> dict:
    """granite-3-8b at full width at T = 16 (what ``launch.serve --coded
    --tp 16`` builds: float32, r = 2 folded; 32/8 heads need no padding)
    through ServingEngine.generate, 4 requests, prompt 16, 16 new tokens:
    fused rounds fault-free and with shard 5 killed at step 4, and the
    reference variant; the three token streams must be identical. Every
    fused round launches kernel 1 200 times (all on the copy engine: wq's
    16-column slices and wk, wv's 4-column ones in boxes of their tile, w1
    and w3's 50-column ones in boxes a vector wider) and kernel 2 once."""
    from repro_torch.models import TPCtx, build
    from repro_torch.serve import ServeConfig, ServingEngine
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg, TPCtx(tp=T16, mode="coded", code_r=R))
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    scfg = ServeConfig(max_len=16 + N_TOK + 8, batch=4,
                       cache_dtype=torch.float32)
    batch = serve_batch(cfg.vocab)
    eng = ServingEngine(model, params, scfg, use_fused=True,
                        use_graphs=True)
    clean = _serve_run(eng, batch)
    _check_graph_run("T=16 fault-free", clean, 1)
    faulty = _serve_run(eng, batch, fail_at={4: 5})
    _check_graph_run("T=16 shard 5 dead", faulty, 1)
    eng.valid = np.ones(T16, bool)
    eng.use_graphs = False
    eager = _serve_run(eng, batch)
    _check_eager_run("T=16 eager", eager)
    del eng
    ref_eng = ServingEngine(model, params, scfg, use_fused=False)
    reference = _serve_run(ref_eng, batch)
    del ref_eng
    rounds = N_TOK - 1
    for name, res in (("fault-free", clean), ("shard 5 dead", faulty)):
        _check_launches(f"T=16 {name}", res, cfg, rounds, norms=True)
        if set(res["k1_variants"]) != {"rb4-async", "rb4-async-lead"} or \
                res["k2_variants"] != {"rb4-async": rounds}:
            raise AssertionError(f"T=16 {name}: instantiations "
                                 f"{res['k1_variants']} / "
                                 f"{res['k2_variants']}")
    if reference["k1"] or reference["k2"]:
        raise AssertionError("the T=16 reference variant launched a kernel")
    for name, res in (("shard 5 dead", faulty), ("reference", reference),
                      ("eager fused", eager)):
        if not np.array_equal(res["tokens"], clean["tokens"]):
            raise AssertionError(f"T=16 {name} tokens differ from the fused "
                                 f"fault-free run:\n{res['tokens']}\nvs\n"
                                 f"{clean['tokens']}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = {n: float(np.median(r["round_ms"])) for n, r in
           (("fused", clean), ("erasure", faulty), ("reference", reference))}
    log(f"served granite-3-8b at T = 16 (r = 2 folded, float32; params in "
        f"{init_s:.1f} s): identical streams on graph rounds fault-free "
        f"and with shard 5 erased at step 4 ({clean['vstep']['n_captures']} "
        f"+ {faulty['vstep']['n_captures']} graphs captured, "
        f"{clean['vstep']['n_replays']} + {faulty['vstep']['n_replays']} "
        f"replays), on eager fused rounds, and on the reference variant; "
        f"per fused round "
        f"{clean['k1'] // rounds} coded-GEMM launches "
        f"({clean['k1_variants']}) + {clean['k2'] // rounds} head "
        f"({clean['k2_variants']}); round medians {med} ms; "
        f"max_memory_allocated {peak:.2f} GiB")
    log("T=16 first stream:", clean["tokens"][0].tolist())
    return {"k1": clean["k1"], "k2": clean["k2"],
            "k1_variants": clean["k1_variants"], "round_ms": med,
            "eager_round_ms": float(np.median(eager["round_ms"])),
            "peak_gib": peak}


@contextlib.contextmanager
def recorded_rounds():
    """Keep what every decode round of VStep computes: the fused round's
    (token, max logit) from its own kernel-2 call (``VStep.last_head``,
    which a graph replay rewrites: copied on the device after each round),
    and the reference round's last-position logits."""
    from repro_torch.runtime.executor import vstep
    rec: dict[str, list] = {"fused": [], "reference": []}
    original = vstep.VStep.round

    def recorded(self, *a):
        out = original(self, *a)
        if self.last_variant == "fused":
            rec["fused"].append(tuple(t.clone() for t in self.last_head))
        else:
            rec["reference"].append(out[2][:, 0])
        return out

    vstep.VStep.round = recorded
    try:
        yield rec
    finally:
        vstep.VStep.round = original


def split_report(ft, rt, fused: list, reference: list, tol: float) -> list:
    """Where a fused stream first leaves the reference stream (token j >=
    1, made by decode round j - 1 from the same history): the reference
    round's top-2 logit gap, how far below the reference's max it puts the
    fused token, and kernel 2's max there. A fused token within ``tol`` of
    the reference's max is a bf16 rounding tie; one further below is a
    fault, and raises."""
    out = []
    for i, (a, b) in enumerate(zip(ft, rt)):
        j = int(np.argmin(np.append(a == b, False)))
        if j == len(a):
            continue
        if j == 0:
            raise AssertionError(f"bf16 stream {i}: the prefill tokens "
                                 f"differ ({a[0]} vs {b[0]})")
        logits = reference[j - 1][i].float()
        top = logits.topk(2).values
        below = float(top[0] - logits[int(a[j])])
        out.append({"stream": i, "token": j, "fused": int(a[j]),
                    "reference": int(b[j]),
                    "reference_top2_gap": float(top[0] - top[1]),
                    "fused_below_reference_max": below,
                    "fused_max": float(fused[j - 1][1][i]),
                    "reference_max": float(top[0])})
        if below > tol:
            raise AssertionError(f"bf16 stream {i} leaves the reference at "
                                 f"token {j} for a token {below:.4f} below "
                                 f"the reference's max (TOL {tol}): "
                                 f"{out[-1]}")
    return out


def serve_bf16(cfg) -> dict:
    """A bf16 coded granite-3-8b at full width (Model.init(dtype=bf16), T
    = 4, r = 2 folded): its parity encoded by kernel 4 on bf16 (6 leaves at
    init, 6 again at the engine's encode); 16 tokens served through the
    fused round (kernels 1, 2 and 6 on bf16: their bf16 instantiations,
    200 + 1 + 81 launches a round) and on the reference variant. The max
    logit of the first served round, from the fused round's own kernel-2
    call, must be within the reference's bf16 TOL (6e-2) of the reference
    round's; where a fused stream leaves the reference one (bf16 rounds
    in other places on the two paths: the streams are not required
    equal), its token must be within that TOL of the reference's max
    (``split_report``). Reported: the leading tokens on which the streams
    agree, device time per fused round by the profiler, a bf16 re-encode
    bitwise equal to the first, and kernel 4 timed per leaf and whole on
    the bf16 weights."""
    from repro_torch.kernels import cdc_encode
    from repro_torch.models import TPCtx, build
    from repro_torch.serve import ServeConfig, ServingEngine
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R))
    cdc_encode.cdc_encode.launches = 0
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=torch.bfloat16, device="cuda")
    scfg = ServeConfig(max_len=16 + N_TOK + 8, batch=4,
                       cache_dtype=torch.bfloat16)
    batch = serve_batch(cfg.vocab)
    eng = ServingEngine(model, params, scfg, use_fused=True,
                        use_graphs=True)
    torch.cuda.synchronize()
    encodes = cdc_encode.cdc_encode.launches
    leaves = _parity_leaves(eng.params)
    if encodes != 2 * len(leaves) or any(p.dtype != torch.bfloat16
                                         for p in leaves):
        raise AssertionError(f"bf16 model: {encodes} encode launches for "
                             f"{len(leaves)} leaves (twice), parity dtypes "
                             f"{sorted({str(p.dtype) for p in leaves})}")
    with recorded_rounds() as rec_f:
        fused = _serve_run(eng, batch)
    rounds = N_TOK - 1
    _check_graph_run("bf16 fused", fused, 1)
    _check_launches("bf16 fused", fused, cfg, rounds, norms=True)
    if set(fused["k1_variants"]) != {"rb4-async-bf16"} or \
            fused["k2_variants"] != {"rb4-async-lead-bf16": rounds} or \
            len(rec_f["fused"]) != rounds or rec_f["reference"]:
        raise AssertionError(f"bf16 fused: instantiations "
                             f"{fused['k1_variants']} / "
                             f"{fused['k2_variants']}, "
                             f"{len(rec_f['fused'])} fused and "
                             f"{len(rec_f['reference'])} reference rounds")
    med = float(np.median(fused["round_ms"]))
    breakdown = profile_rounds(eng.executor(4), eng.valid, med)
    eng.use_graphs = False
    eager = _serve_run(eng, batch)
    _check_eager_run("bf16 eager", eager)
    if not np.array_equal(eager["tokens"], fused["tokens"]):
        raise AssertionError(f"bf16 graph and eager fused rounds differ:\n"
                             f"{fused['tokens']}\nvs\n{eager['tokens']}")
    encode = reencode_and_time(eng.stepper)
    del eng
    ref_eng = ServingEngine(model, params, scfg, use_fused=False)
    with recorded_rounds() as rec_r:
        reference = _serve_run(ref_eng, batch)
    del ref_eng
    if len(rec_r["reference"]) != rounds or rec_r["fused"]:
        raise AssertionError(f"bf16 reference: {len(rec_r['reference'])} "
                             f"reference and {len(rec_r['fused'])} fused "
                             f"rounds")
    fmax = rec_f["fused"][0][1]
    rmax = rec_r["reference"][0].float().max(-1).values
    torch.testing.assert_close(fmax, rmax, rtol=6e-2, atol=6e-2, msg=(
        lambda m: f"bf16 first served round's max logit, fused vs "
                  f"reference: {m}"))
    ft, rt = fused["tokens"], reference["tokens"]
    agree = [int(np.argmin(np.append(a == b, False))) for a, b in zip(ft, rt)]
    splits = split_report(ft, rt, rec_f["fused"], rec_r["reference"], 6e-2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"bf16 granite-3-8b (T=4, r=2 folded): parity by kernel 4 on bf16 "
        f"({encodes} launches); first served round's max logit, fused "
        f"(kernel 2) {fmax.tolist()} vs reference {rmax.tolist()} (max abs "
        f"diff {float((fmax - rmax).abs().max()):.4f}, TOL 6e-2); fused "
        f"round median {med:.3f} ms on graph rounds (eager: "
        f"{float(np.median(eager['round_ms'])):.3f} ms, identical tokens), "
        f"reference "
        f"{float(np.median(reference['round_ms'])):.3f} ms; leading tokens "
        f"agreeing per stream {agree} of {N_TOK}; where they split {splits}; "
        f"launches a round "
        f"{fused['k1'] // rounds} / {fused['k2'] // rounds} / "
        f"{norms_per_pass(cfg)} ({fused['k1_variants']}, "
        f"{fused['k2_variants']}, {fused['k6_variants']}); "
        f"max_memory_allocated {peak:.2f} GiB")
    return {"first_step_max": {"fused": fmax.tolist(),
                               "reference": rmax.tolist()},
            "agree": agree, "splits": splits, "round_ms": med,
            "eager_round_ms": float(np.median(eager["round_ms"])),
            "breakdown": breakdown, "encode": encode, "encodes": encodes,
            "peak_gib": peak}


# ------------------------------------------------------------ phase 5 ----

CHAOS = "exp:mtbf=800,mttr=120"
CHAOS_SEED = 2     # its schedule has in-step recoveries, beyond-budget
#                    requeues and re-encodes, and drives the planner to r=4
SCHED_ARGS = ["--coded", "--tp", str(T), "--batch", "4", "--requests", "8",
              "--arrival-gap-ms", "2", "--prompt-len", "16",
              "--gen-tokens", "16", "--seed", str(CHAOS_SEED)]
RUNS = {"fault-free": [], "chaos": ["--chaos", CHAOS],
        "chaos+adapt-r": ["--chaos", CHAOS, "--adapt-r"]}
# the observability flags of each run on the card (the CPU runs that
# give the expected counters take none): the perf line, the validated
# trace and the SLO report, a torch.profiler trace
SMOKE_OUT = ROOT / "build" / "smoke"
OBS = {"fault-free": ["--perf"],
       "chaos": ["--trace", str(SMOKE_OUT / "chaos.trace.json"),
                 "--slo-report"],
       "chaos+adapt-r": ["--profile", str(SMOKE_OUT / "profile")]}


def _kernel_wrappers():
    from repro_torch.kernels import (cdc_decode, cdc_encode, cdc_matmul,
                                     matmul, rmsnorm)
    return {"cdc_coded_matmul": cdc_matmul.cdc_coded_matmul,
            "cdc_fused_head_argmax": cdc_decode.cdc_fused_head_argmax,
            "cdc_encode": cdc_encode.cdc_encode,
            "cdc_decode_merge": cdc_matmul.cdc_decode_merge,
            "cdc_decode": cdc_decode.cdc_decode,
            "rmsnorm": rmsnorm.rmsnorm, "matmul": matmul.matmul}


def _scheduler_run(model, params, vocab: int, argv: list[str], device: str,
                   report: bool = False):
    """One run of the port's serving entry point (``launch.serve``): the
    stepper (whose build encodes the parity), the scheduler with the
    chaos injector, planner and observability the flags ask for, and the
    request stream; with ``report``, the entry point's summary lines
    (returning the perf summary and trace statistics)."""
    from repro_torch.launch import serve
    from repro_torch.serve import ModelStepper
    args = serve.parser().parse_args(argv + ["--device", device])
    stepper = ModelStepper(model, params,
                           max_len=args.prompt_len + args.gen_tokens + 8)
    sched = serve.build_scheduler(args, stepper, model.ctx.code_layout)
    done = serve.serve_requests(args, sched, vocab)
    out = serve.report(args, sched, done) if report else {}
    return stepper, sched, done, out


def scheduler_counters_cpu() -> dict:
    """The three runs' counters and planner r series at smoke size on the
    CPU: the schedule depends on the seed and the arrivals, not on the
    model's width, so the full-width runs must give the same ones."""
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import TPCtx, build
    cfg = smoke_config(get_arch("granite-3-8b"))
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R))
    params = model.init(0, device="cpu")
    out = {}
    for name, extra in RUNS.items():
        _, sched, done, _ = _scheduler_run(model, params, cfg.vocab,
                                           SCHED_ARGS + extra, "cpu")
        out[name] = {"counters": dict(sched.metrics.counters),
                     "r_series": [p["r"] for p in sched.metrics.plan_log],
                     "completed": len(done)}
    return out


def _parity_leaves(params) -> list[torch.Tensor]:
    out = []
    for v in params.values():
        if isinstance(v, dict):
            out += _parity_leaves(v)
    if "cdc" in params:
        out.append(params["cdc"])
    return out


def serve_scheduler(cfg, device: str = "cuda") -> dict:
    """granite-3-8b at full width through the continuous-batching
    scheduler: fault-free, under seeded chaos, and under chaos with the
    adaptive planner, the same 8 requests each time."""
    from repro_torch.models import TPCtx, build
    t0 = time.perf_counter()
    expect = scheduler_counters_cpu()
    log(f"scheduler, smoke size on the CPU ({time.perf_counter() - t0:.1f} "
        f"s): " + "; ".join(
            f"{n}: {e['counters']['decode_rounds']} rounds, "
            f"{e['counters']['erasures_recovered']} recovered in-step, "
            f"{e['counters']['beyond_budget_failures']} beyond budget, "
            f"{e['counters']['parity_reencodes']} re-encodes, r series "
            f"{e['r_series']}" for n, e in expect.items()))
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R))
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    wrappers = _kernel_wrappers()
    SMOKE_OUT.mkdir(parents=True, exist_ok=True)
    runs, timing = {}, None
    for name, extra in RUNS.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        stepper, sched, done, obs = _scheduler_run(
            model, params, cfg.vocab, SCHED_ARGS + extra + OBS[name],
            device, report=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = {k: fn.launches for k, fn in wrappers.items()}
        c = dict(sched.metrics.counters)
        rs = [p["r"] for p in sched.metrics.plan_log]
        n_leaves = len(_parity_leaves(stepper.params))
        res = {"tokens": {q.rid: list(q.tokens) for q in done},
               "counters": c, "r_series": rs, "seconds": secs,
               "launches": launches,
               "round_ms": float(np.median(sched.executor.round_ms)),
               "reencode_wall_ms": stepper.last_reencode_wall_ms,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "graphs": _check_scheduler_graphs(name, sched, stepper, T)}
        res.update(_check_observability(name, sched, stepper, obs))
        runs[name] = res
        want = expect[name]
        if len(done) != 8 or any(len(q.tokens) != 16 for q in done):
            raise AssertionError(f"{name}: {len(done)}/8 requests completed")
        if c != want["counters"] or rs != want["r_series"]:
            raise AssertionError(
                f"{name}: counters {c} / r series {rs} differ from the "
                f"CPU run's {want['counters']} / {want['r_series']}")
        if launches["cdc_encode"] != n_leaves * (1 + c["parity_reencodes"]):
            raise AssertionError(
                f"{name}: {launches['cdc_encode']} encode launches for "
                f"{1 + c['parity_reencodes']} encodes of {n_leaves} leaves")
        if not (launches["cdc_coded_matmul"] and
                launches["cdc_fused_head_argmax"]):
            raise AssertionError(f"{name}: no fused round ran: {launches}")
        # every dispatched round (fused or reference) and every prefill
        # (one per admission, requeued requests' second ones included)
        # runs its norms through kernel 6
        passes = sched.executor.vstep.n_dispatches + c["requests_admitted"]
        res["passes"] = {"rounds": sched.executor.vstep.n_dispatches,
                         "prefills": c["requests_admitted"]}
        if launches["rmsnorm"] != norms_per_pass(cfg) * passes:
            raise AssertionError(
                f"{name}: {launches['rmsnorm']} rmsnorm launches for "
                f"{res['passes']}; expected {norms_per_pass(cfg)} each")
        if name != "fault-free" and res["tokens"] != runs["fault-free"][
                "tokens"]:
            raise AssertionError(f"{name}: token streams differ from the "
                                 f"fault-free run")
        log(f"scheduler {name}: {c['requests_completed']}/8 completed, "
            f"{c['decode_rounds']} rounds in {secs:.2f} s, round_ms median "
            f"{res['round_ms']:.3f}, {c['erasures_recovered']} recovered "
            f"in-step, {c['beyond_budget_failures']} beyond budget, "
            f"{c['requests_requeued']} requeued, {c['parity_reencodes']} "
            f"re-encodes (last {res['reencode_wall_ms']:.3f} ms wall), r "
            f"series {rs}, launches {launches}, max_memory_allocated "
            f"{res['peak_gib']:.2f} GiB")
        if name == "fault-free":
            # before the chaos runs, so that only one parity set is alive
            timing = reencode_and_time(stepper)
        del stepper, sched, done
    chaos, adapt = runs["chaos"]["counters"], runs["chaos+adapt-r"]
    if not (chaos["erasures_recovered"] and chaos["beyond_budget_failures"]
            and chaos["parity_reencodes"]):
        raise AssertionError(f"chaos run lacks a recovery, a requeue or a "
                             f"re-encode: {chaos}")
    if 4 not in adapt["r_series"]:
        raise AssertionError(f"the planner never reached r=4: "
                             f"{adapt['r_series']}")
    log("scheduler: every request completed in all three runs, token "
        "streams identical to the fault-free run, counters equal to the "
        "CPU run's")
    return {"runs": runs, "timing": timing}


def _check_scheduler_graphs(name: str, sched, stepper, t: int) -> dict:
    """A scheduler run on graph rounds: one replay per fused round, at
    most T + 1 graphs per encode generation, none left from an older
    generation; graphs dropped at most once per encode after the first
    (a re-encode or an r change)."""
    vs = sched.executor.vstep
    gen = stepper.encode_generation
    c = {k: getattr(vs, k) for k in VSTEP_COUNTERS}
    stale = [k for k in vs._graphs if k[0] != gen]
    if not vs.use_graphs or c["n_replays"] != c["n_fused_rounds"] \
            or c["n_captures"] > (t + 1) * (gen + 1) \
            or c["n_graph_drops"] > gen or stale:
        raise AssertionError(f"{name}: graph counters {c}, {gen} encodes "
                             f"after the first, stale graphs {stale}")
    rs = [R] + [p["r"] for p in sched.metrics.plan_log if p["applied"]]
    resizes = sum(a != b for a, b in zip(rs, rs[1:]))
    log(f"scheduler {name}: {c['n_replays']} replays for "
        f"{c['n_fused_rounds']} fused of {c['n_dispatches']} rounds, "
        f"{c['n_captures']} graphs captured, dropped {c['n_graph_drops']} "
        f"times beside {sched.metrics.counters['parity_reencodes']} "
        f"re-encodes ({resizes} of them r changes; {gen} encodes after "
        f"the first)")
    return {**c, "encodes_after_first": gen, "r_changes": resizes}


# the fused round's counted bytes over the weights' bytes, at full width:
# activations, the KV cache and the embedding rows add under 5%
PERF_BOUND_TOL = 0.05


def _round_weight_bytes(stepper) -> float:
    """Bytes a fused round must read at the least: every layer weight and
    parity leaf, the LM head and its sum parity (a shard's width)."""
    def leaves(node):
        if isinstance(node, dict):
            return [t for v in node.values() for t in leaves(v)]
        return [node]
    head = stepper.params["lm_head"]["w"]
    return float(sum(t.numel() * t.element_size()
                     for t in leaves(stepper.params["layers"]))
                 + head.numel() * head.element_size()
                 * (1 + 1 / stepper.n_shards))


def _check_observability(name: str, sched, stepper, obs: dict) -> dict:
    """What each run's observability flag must give: the perf line's
    attribution (every launch costed; its bytes bound within 5% of the
    round's weight bytes over the card's HBM rate), the chaos trace
    (validated with every injected erasure linked, 0 dropped events) with
    the SLO report, the profiler trace file."""
    from repro_torch.obs.export import validate_chrome_trace
    out = {}
    if "--perf" in OBS[name] or "--profile" in OBS[name] \
            or "--trace" in OBS[name]:
        perf = obs.get("perf")
        if not perf or any(c.get("custom_calls_uncosted") != 0
                           for c in perf["variants"].values()) \
                or "fused" not in perf["variants"]:
            raise AssertionError(f"{name}: perf summary {perf}")
        # the fused round at the run's last code geometry
        fused = perf["variants"]["fused"]
        want = _round_weight_bytes(stepper) / HBM_BYTES_PER_S * 1e6
        got = fused["bound_step_s"] * 1e6
        if fused["dominant"] != "memory" or \
                abs(got / want - 1) > PERF_BOUND_TOL:
            raise AssertionError(f"{name}: fused-round bound {got:.1f} us, "
                                 f"weights alone {want:.1f} us")
        out["perf"] = {k: v for k, v in perf.items() if k != "variants"}
        out["perf"]["weight_bound_us"] = want
        out["perf"]["attributions"] = sched.executor.perf.n_attributions
        out["perf"]["fused"] = fused
        log(f"scheduler {name}: fused-round bound {got / 1e3:.4f} ms "
            f"(weights alone {want / 1e3:.4f} ms), {fused['flops'] / 1e9:.3f}"
            f" GFLOP ({fused['useful_flops'] / 1e9:.3f} useful, "
            f"{fused['bytes'] / 1e9:.3f} GB), "
            f"{sched.executor.perf.n_attributions} attribution(s)")
    if "--trace" in OBS[name]:
        path = OBS[name][OBS[name].index("--trace") + 1]
        with open(path) as f:
            stats = validate_chrome_trace(json.load(f),
                                          require_fault_links=True,
                                          require_span_closure=True)
        if stats["dropped_events"] != 0 or \
                stats["n_linked"] != stats["n_injected_erasures"]:
            raise AssertionError(f"{name}: trace {stats}")
        out["trace"] = stats
        log(f"scheduler {name}: trace validated with every fault linked "
            f"({stats['n_linked']} of {stats['n_injected_erasures']} "
            f"injected erasures, {stats['dropped_events']} dropped events, "
            f"{stats['n_span_trees']} span trees)")
    if "--profile" in OBS[name]:
        path = Path(OBS[name][OBS[name].index("--profile") + 1]) / \
            "trace.json"
        size = path.stat().st_size if path.exists() else 0
        if size == 0:
            raise AssertionError(f"{name}: no profiler trace at {path}")
        out["profile_bytes"] = size
        log(f"scheduler {name}: torch.profiler trace {path} ({size} bytes)")
    return out


def reencode_and_time(stepper) -> dict:
    """A re-encode of unchanged weights must give bitwise-equal parity;
    then kernel 4 per leaf and for the whole re-encode, its bound, its
    plain version (the tensordot-and-fold path) and torch.matmul on a
    contiguous copy of the shards (the yardstick), in the weights'
    storage type."""
    from repro_torch.core.coding import generator_matrix
    from repro_torch.kernels import cdc_encode as enc
    before = [p.clone() for p in _parity_leaves(stepper.params)]
    walls = []
    for _ in range(3):
        stepper.reencode()
        walls.append(stepper.last_reencode_wall_ms)
    after = _parity_leaves(stepper.params)
    if len(after) != len(before) or not all(
            torch.equal(a, b) for a, b in zip(after, before)):
        raise AssertionError("re-encoding unchanged weights changed the "
                             "parity bits")
    del before, after
    torch.cuda.empty_cache()
    log(f"re-encode of unchanged weights: every parity leaf bitwise equal; "
        f"last_reencode_wall_ms {', '.join(f'{x:.3f}' for x in walls)}")
    scratch = torch.empty(64 * 2 ** 20, device="cuda")   # 256 MB > L2
    flush = scratch.zero_
    g = generator_matrix(T, R)
    raw = stepper._raw_params
    dtype = raw["lm_head"]["w"].dtype
    e = torch.finfo(dtype).bits / 8
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    gt = torch.as_tensor(g.astype(np.float32), device="cuda").to(dtype)
    leaves = [("wq", raw["layers"]["attn"]["wq"]["w"]),
              ("wk", raw["layers"]["attn"]["wk"]["w"]),
              ("wv", raw["layers"]["attn"]["wv"]["w"]),
              ("w1", raw["layers"]["ffn"]["w1"]["w"]),
              ("w3", raw["layers"]["ffn"]["w3"]["w"]),
              ("lm_head", raw["lm_head"]["w"])]
    rows = []
    for name, w in leaves:
        sh = _shards(w, T)
        ms = _time(lambda: enc.cdc_encode(sh, g, layout="folded"), flush, 10)
        plain = _time(lambda: enc.encode_plain(sh, g, "folded"), flush, 5)
        flat = sh.contiguous().reshape(sh.shape[:-2] + (-1,))
        lib = _time(lambda: torch.matmul(gt, flat), flush, 10)
        del flat
        n = sh.numel()                     # T * (L *) k * m_l
        bound, by = _bound(e * n * (T + R) / T, 2.0 * n * R, peak)
        rows.append({"leaf": name, "shape": list(w.shape), "ms": ms,
                     "plain_ms": plain, "library_ms": lib,
                     "bound_ms": bound, "bound_by": by})
        log(f"cdc_encode {name} {list(w.shape)} {dtype} T={T} r={R} folded: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library matmul "
            f"{lib:.4f} ms, bound {bound:.4f} ms ({by})")
    whole = _time(lambda: stepper.model.encode_offline(raw), flush, 10)
    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"whole re-encode ({len(rows)} launches, {dtype}): {whole:.4f} ms "
        f"by events around encode_offline; per-leaf sums: kernel "
        f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, library "
        f"{total['library_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms")
    return {"leaves": rows, "whole_ms": whole, "total": total,
            "reencode_wall_ms": walls}


# --------------------------------------------------------------- main ----

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.device import set_true_f32
    from repro_torch.kernels import build
    set_true_f32()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    report = build.build_all()
    log(f"built {sorted(report)} in {time.perf_counter() - t0:.1f} s")
    spills = []
    for name, rep in report.items():
        entry = ""
        for line in rep["ptxas"].splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                use = line.split(":", 2)[-1].strip()
                if "spill" in line and \
                        "0 bytes spill stores, 0 bytes spill loads" not in use:
                    spills.append(f"{entry}: {use}")
                if "registers" in line:
                    PTXAS[entry] = use
                log(f"  {name} {entry}: {use}")
    if spills:
        raise AssertionError(f"ptxas spills: {spills}")

    cfg = get_arch("granite-3-8b")
    torch.cuda.reset_peak_memory_stats()
    err4 = check_encode(cfg)
    err4_bf16, _ = check_encode_bf16(cfg)
    err1 = max(check_coded_matmul(), check_coded_matmul_r34(),
               check_coded_matmul_t8(), check_coded_matmul_t16())
    err1_bf16 = check_coded_matmul_bf16()
    edge1, edge7 = check_stream_edges()
    err2 = max(check_fused_head(cfg), check_head_edges())
    err2_bf16 = max(check_fused_head_wide(cfg),
                    check_head_edges(torch.bfloat16))
    err3 = check_decode_merge()
    err5 = check_decode()
    err6 = max(check_rmsnorm(), check_rmsnorm_edges())
    err7 = max(check_matmul(), edge7)
    err1 = max(err1, edge1)
    _phase_memory("kernel checks")
    served = serve_full_width(cfg)
    torch.cuda.empty_cache()
    timed = time_kernels(cfg)
    torch.cuda.empty_cache()
    sched = serve_scheduler(cfg)
    torch.cuda.empty_cache()
    study = run_study()
    entry = decode_merge_entry()
    _phase_memory("study and library entry")
    t16 = serve_t16(cfg)
    _phase_memory("serving at T = 16")
    bf16 = serve_bf16(cfg)
    _phase_memory("serving on bf16 weights")
    w1 = timed[0]
    head = next(t for t in timed if t.get("gemm") == "lm_head")
    small = {(t["kernel"], t["shape"]): t for t in timed if "kernel" in t}
    enc = sched["timing"]["total"]

    def entry_of(name, src, replaces, launches, err, row):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{src}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}

    # launches: kernels 1, 2 and 6 from the fused serving run (phase 3),
    # kernel 4 from the chaos run (phase 5), kernels 5 and 7 from the
    # study (phase 6), kernel 3 from its library entry (phase 7)
    kernels = [
        entry_of("cdc_coded_matmul", "coded_matmul.cuh",
                 "src/repro/kernels/cdc_matmul.py:130", served["k1"], err1,
                 w1),
        entry_of("cdc_fused_head_argmax", "fused_head.cuh",
                 "src/repro/kernels/cdc_decode.py:138", served["k2"], err2,
                 head),
        entry_of("cdc_decode_merge", "cdc_decode_merge.cu",
                 "src/repro/kernels/cdc_matmul.py:208", entry["launches"],
                 err3, small[("cdc_decode_merge",
                              f"[{T}, 4, {GEMMS['w1']}] r={R} folded")]),
        entry_of("cdc_encode", "cdc_encode.cu",
                 "src/repro/kernels/cdc_encode.py:30",
                 sched["runs"]["chaos"]["launches"]["cdc_encode"], err4,
                 {**enc, "bound_by": "bytes"}),
        entry_of("cdc_decode", "cdc_decode.cu",
                 "src/repro/kernels/cdc_decode.py:56",
                 study["launches"]["cdc_decode"], err5,
                 small[("cdc_decode", "[8, 256, 512]")]),
        entry_of("rmsnorm", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:25",
                 served["k6"], err6, small[("rmsnorm", f"[4, {K}]")]),
        entry_of("matmul", "matmul.cu", "src/repro/kernels/matmul.py:31",
                 study["launches"]["matmul"], err7,
                 small[("matmul", "[512, 512] @ [512, 512]")]),
    ]
    log(card)
    runs = {n: {k: v for k, v in r.items() if k != "tokens"}
            for n, r in sched["runs"].items()}
    log(json.dumps({"shapes": timed, "round": served["breakdown"],
                    "graph_vs_eager": served["graph_vs_eager"],
                    "encode": sched["timing"], "scheduler": runs,
                    "study": study, "decode_merge_entry": entry,
                    "t16": t16, "bf16": bf16,
                    "bf16_max_abs_err": {"cdc_coded_matmul": err1_bf16,
                                         "cdc_fused_head_argmax": err2_bf16,
                                         "cdc_encode": err4_bf16}}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
