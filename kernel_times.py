#!/usr/bin/env python3
"""Time kernels 1, 2, 3, 5, 6 and 7 of one checkout of the port on one card.

  python3 kernel_times.py [--src DIR] [--tag NAME] [--new]

DIR is the ``src`` directory of the checkout to time (default: this
one's). To compare two commits on the same card, unpack the other one
(``git archive``) under ``results/`` and run, in one call, parent, change,
change, parent. Each run builds that checkout's kernels and prints one
JSON line per shape: the kernel's median device ms over 30 calls (CUDA
events, a 256 MB buffer zeroed before each call so the weights start
cold, a spin kernel covering the host's enqueue), beside one
``torch.matmul`` over the same weights. Kernel 1 at granite-3-8b's w1
((T, r) = (4, 2) and (4, 4) folded), wq and wk at rows 4, 16 and 64;
kernel 2 (the fused head) at 4 and 16 rows; kernel 6 (RMSNorm) at
[4, 4096] and [64, 4096] beside ``F.rms_norm``; kernel 7 at 512^3 and
granite's Wo at 4 rows. Kernel 6 is also timed by torch.profiler: its
device time per call over 200 calls with the inputs in L2, as the
serving round finds them (CUDA events around a ~2 us kernel read the
events' own floor). Kernels 3 and 5 are timed by torch.profiler too
(device time per call over 200 calls, back to back) at the kernel table's
shapes and at 2048 rows, beside an empty kernel (``torch.cuda._sleep(0)``)
that gives the card's launch floor, and by events at 2048 rows. The first
line is the build: nvcc's wall time for the checkout's sources. Needs only
the wrappers' public signatures, which both sides share. ``--new`` adds
what only this tree runs: kernels 1 and 2 on bf16 weights (T = 4) and at
T = 16 (float32), beside ``torch.matmul`` over the same weights in their
storage type; kernel 1 at the shapes only its row-copy instantiation takes
(``ROWCOPY_TIMED``: T = 12's w1, bf16 and odd r at T = 16), with its
bound; and kernel 4 at T = 12's w1 leaf (``ENCODE_T12``) beside its bound
and ``torch.matmul`` of the generator over a contiguous copy of the
shards.

  python3 kernel_times.py --tma-probe

copies one TMA box whose first column is 4, 8 or 12 bytes past a 16-byte
boundary (``csrc/tma_probe.cu``) and prints, for each start, whether the
box equals the source columns.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

K, T = 4096, 4
SPIN_CYCLES = 4_000_000
# Kernels 1 and 2 on bf16 weights at T = 4 and in float32 at T = 16, at the
# decode round's 4 rows: (T, storage type, kernel 1's (gemm, full width,
# r) folded); kernel 2 at granite's head. chip_smoke.py's phase 4 times
# the same shapes.
WIDE_AND_BF16 = tuple(
    (t, dtype, (("w1", 12800, 2), ("w1", 12800, 4), ("wq", 4096, 2),
                ("wk", 1024, 2)))
    for t, dtype in ((T, torch.bfloat16), (16, torch.float32)))
# Kernel 1's row-copy instantiation (shapes the copy engine cannot take) at
# 4 rows, folded: (T, storage type, gemm, full width, r). T = 12's w1 is
# granite's d_ff padded to 12816 (89-column slices); at T = 16 w1's
# 50-column slices are 100 bytes on bf16, and odd r makes float32 parity
# rows of 200 r bytes. chip_smoke.py's phase 4 times the same shapes.
ROWCOPY_TIMED = ((12, torch.float32, "w1", 12816, 2),
                 (16, torch.bfloat16, "w1", 12800, 2),
                 (16, torch.float32, "w1", 12800, 1),
                 (16, torch.float32, "w1", 12800, 3))
# Kernel 4 at granite's w1 leaf at T = 12 (40 layers stacked, k 4096, d_ff
# padded to 12816), r = 2 folded: the largest leaf of a T = 12 re-encode.
ENCODE_T12 = (40, 4096, 12816)


def _time(fn, flush, n=30) -> float:
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
    """Device microseconds per call of ``fn`` spent in the kernels whose
    name holds ``name`` (every kernel for ""), by torch.profiler over n
    calls, the inputs left in L2."""
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
    return us / n if us else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent
                                         / "src"))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--new", action="store_true",
                    help="also kernels 1 and 2 on bf16 and at T = 16, "
                         "kernel 1's row-copy shapes and kernel 4 at T = 12")
    ap.add_argument("--tma-probe", action="store_true",
                    help="only the TMA box-start probe")
    ap.add_argument("--tma-probe-start", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    if args.tma_probe_start is not None:
        return tma_probe_start(args.tma_probe_start)
    if args.tma_probe:
        return tma_probe(args.src)
    from repro_torch.core.coded_layer import (CodedDenseSpec,
                                              make_parity_weights,
                                              unfold_parity)
    from repro_torch.core.coding import CodeSpec
    from repro_torch.device import set_true_f32
    from repro_torch.kernels import (build, cdc_decode, cdc_matmul, matmul,
                                     ops, rmsnorm)
    set_true_f32()
    t0 = time.perf_counter()
    built = build.build_all()
    build_s = time.perf_counter() - t0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(13)
    flush = torch.empty(64 * 2 ** 20, device="cuda").zero_

    def emit(**row):
        print(json.dumps({"tag": args.tag, "card": card, **row}), flush=True)

    # nvcc's wall time for the sources this run had to build (all of them
    # in a fresh checkout, one nvcc each, in parallel)
    emit(kernel="build", sources=sorted(built), seconds=build_s)

    for name, m_l, r, rows in [("w1", 3200, 2, 4), ("w1", 3200, 4, 4),
                               ("wq", 1024, 2, 4), ("wk", 256, 2, 4),
                               ("w1", 3200, 2, 16), ("wq", 1024, 2, 16),
                               ("wk", 256, 2, 16), ("w1", 3200, 2, 64),
                               ("wq", 1024, 2, 64), ("wk", 256, 2, 64)]:
        spec = CodedDenseSpec(CodeSpec(T, r), layout="folded")
        x = torch.randn((rows, K), generator=gen, device="cuda")
        w = torch.randn((K, T * m_l), generator=gen, device="cuda") / K ** .5
        wc = make_parity_weights(w, spec)
        vh = (True,) * T
        esel, coef, g = ops.decode_plan(spec, vh, vh, m_l, "cuda")
        wcat = torch.cat([w, unfold_parity(wc, T, r).permute(1, 0, 2)
                          .reshape(K, r * m_l)], dim=1)
        ms = _time(lambda: cdc_matmul.cdc_coded_matmul(
            x, w, wc, "folded", T, r, g, esel, coef, vh), flush)
        lib = _time(lambda: torch.matmul(x, wcat), flush)
        emit(kernel="cdc_coded_matmul", gemm=name, r=r, rows=rows, ms=ms,
             library_ms=lib)
        del w, wc, wcat
    m_l = 12292                            # granite's head shard at T = 4
    w = torch.randn((K, T * m_l), generator=gen, device="cuda") / K ** .5
    w_shards = w.view(K, T, m_l).permute(1, 0, 2)
    pw = w_shards.sum(0).contiguous()
    wcat = torch.cat([w, pw], dim=1)
    for rows in (4, 16):
        x = torch.randn((rows, K), generator=gen, device="cuda")
        ms = _time(lambda: cdc_decode.cdc_fused_head_argmax(
            x, w_shards, pw, (True,) * T, vocab=49155), flush)
        lib = _time(lambda: torch.matmul(x, wcat), flush)
        emit(kernel="cdc_fused_head_argmax", rows=rows, ms=ms,
             library_ms=lib)
    del w, w_shards, pw, wcat
    g = 1.0 + 0.1 * torch.randn(K, generator=gen, device="cuda")
    for rows in (4, 64):
        x = torch.randn((rows, K), generator=gen, device="cuda")
        ms = _time(lambda: rmsnorm.rmsnorm(x, g, eps=1e-5), flush)
        lib = _time(lambda: F.rms_norm(x, (K,), g, 1e-5), flush)
        emit(kernel="rmsnorm", shape=[rows, K], ms=ms, library_ms=lib,
             profiler_us=_profile_us(lambda: rmsnorm.rmsnorm(x, g, eps=1e-5),
                                     "rmsnorm"),
             library_profiler_us=_profile_us(
                 lambda: F.rms_norm(x, (K,), g, 1e-5), ""))
    for m, k, n in ((512, 512, 512), (4, K, K)):
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
        ms = _time(lambda: matmul.matmul(x, w), flush)
        lib = _time(lambda: torch.matmul(x, w), flush)
        emit(kernel="matmul", shape=[m, k, n], ms=ms, library_ms=lib)
    emit(kernel="empty", profiler_us=_profile_us(
        lambda: torch.cuda._sleep(0), ""))
    # kernel 3 at granite's w1, T = 4, r = 2 folded, shard 2 dead (and all
    # valid at 2048 rows); kernel 5 with shard T / 2 dead
    spec = CodedDenseSpec(CodeSpec(T, 2), layout="folded")
    m_l = 3200
    for rows, valid in ((4, (True, True, False, True)),
                        (64, (True, True, False, True)),
                        (2048, (True, True, False, True)),
                        (2048, (True,) * T)):
        esel, coef, g = ops.decode_plan(spec, valid, valid, m_l, "cuda")
        ys = torch.randn((T, rows, m_l), generator=gen, device="cuda")
        par = torch.randn((T, rows, 2 * m_l // T), generator=gen,
                          device="cuda")
        call = (ys, par, "folded", T, 2, g, esel, coef, valid)
        emit(kernel="cdc_decode_merge", shape=[T, rows, m_l],
             all_valid=all(valid),
             ms=_time(lambda: cdc_matmul.cdc_decode_merge(*call), flush),
             profiler_us=_profile_us(
                 lambda: cdc_matmul.cdc_decode_merge(*call), "decode_merge"))
        del ys, par
    for t, shape in ((8, (256, 512)), (4, (4, 3200)), (4, (2048, 3200))):
        y = torch.randn((t,) + shape, generator=gen, device="cuda")
        p = y.sum(0)
        valid = tuple(i != t // 2 for i in range(t))
        emit(kernel="cdc_decode", shape=[t, *shape],
             ms=_time(lambda: cdc_decode.cdc_decode(y, p, valid), flush),
             profiler_us=_profile_us(
                 lambda: cdc_decode.cdc_decode(y, p, valid), "decode_kernel"))
        del y, p
    if args.new:
        time_new(emit, gen, flush)
    return 0


def tma_probe(src: str) -> int:
    """One [4, 16] float32 TMA box of a [8, 64] matrix at first columns 0
    .. 4, each start in a process of its own (a copy the engine refuses
    faults the context): the printed line says, for each start, whether
    the box equals the source columns, or how the process failed."""
    res = {}
    for c0 in range(5):
        p = subprocess.run([sys.executable, __file__, "--src", src,
                            "--tma-probe-start", str(c0)],
                           capture_output=True, text=True, timeout=120)
        last = (p.stdout.strip().splitlines() or [""])[-1]
        res[f"start {c0 * 4} bytes"] = last if p.returncode == 0 else (
            f"rc {p.returncode}: "
            + " | ".join(p.stderr.strip().splitlines()[-3:]))
    print(json.dumps({"tma_box_start_probe": res,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


def tma_probe_start(c0: int) -> int:
    import ctypes
    from repro_torch.kernels import build
    fn = build.load("tma_probe").cdc_tma_box_probe
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, i, i, p]
    fn.restype = i
    src = torch.arange(8 * 64, dtype=torch.float32, device="cuda").view(8, 64)
    out = torch.full((4, 16), -1.0, device="cuda")
    err = fn(src.data_ptr(), out.data_ptr(), 8, 64, c0, 16, 4,
             build.raw_stream(src.device))
    torch.cuda.synchronize()
    print(f"error {err}" if err else
          "equal" if torch.equal(out, src[:4, c0:c0 + 16]) else
          f"differs (first row {out[0, :6].tolist()})", flush=True)
    return 0


def time_new(emit, gen, flush):
    """Kernels 1 and 2 on bf16 weights at T = 4 and in float32 at T = 16,
    at the decode round's 4 rows, beside torch.matmul over the same
    weights (concatenated, in their storage type)."""
    from repro_torch.core.coded_layer import (CodedDenseSpec,
                                              make_parity_weights,
                                              unfold_parity)
    from repro_torch.core.coding import CodeSpec
    from repro_torch.kernels import cdc_decode, cdc_matmul, ops
    from repro_torch.models.common import TPCtx
    for t, dtype, gemms in WIDE_AND_BF16:
        for name, width, r in gemms:
            m_l = width // t
            spec = CodedDenseSpec(CodeSpec(t, r), layout="folded")
            x = torch.randn((4, K), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((K, width), generator=gen, device="cuda")
                 / K ** .5).to(dtype)
            wc = make_parity_weights(w, spec)
            vh = (True,) * t
            esel, coef, g = ops.decode_plan(spec, vh, vh, m_l, "cuda")
            wcat = torch.cat([w, unfold_parity(wc, t, r).permute(1, 0, 2)
                              .reshape(K, r * m_l)], dim=1)
            ms = _time(lambda: cdc_matmul.cdc_coded_matmul(
                x, w, wc, "folded", t, r, g, esel, coef, vh), flush)
            lib = _time(lambda: torch.matmul(x, wcat), flush)
            emit(kernel="cdc_coded_matmul", gemm=name, r=r, rows=4, T=t,
                 dtype=str(dtype), ms=ms, library_ms=lib)
            del w, wc, wcat
        m = TPCtx(tp=t).pad_dim(49155)
        w = (torch.randn((K, m), generator=gen, device="cuda")
             / K ** .5).to(dtype)
        w_shards = w.view(K, t, m // t).permute(1, 0, 2)
        pw = cdc_decode.head_parity(w_shards)
        wcat = torch.cat([w, pw], dim=1)
        x = torch.randn((4, K), generator=gen, device="cuda")
        xl = x.to(dtype)
        ms = _time(lambda: cdc_decode.cdc_fused_head_argmax(
            x, w_shards, pw, (True,) * t, vocab=49155), flush)
        lib = _time(lambda: torch.matmul(xl, wcat), flush)
        emit(kernel="cdc_fused_head_argmax", rows=4, T=t, dtype=str(dtype),
             ms=ms, library_ms=lib)
        del w, w_shards, pw, wcat
    for t, dtype, name, width, r in ROWCOPY_TIMED:
        m_l = width // t
        spec = CodedDenseSpec(CodeSpec(t, r), layout="folded")
        x = torch.randn((4, K), generator=gen, device="cuda").to(dtype)
        w = (torch.randn((K, width), generator=gen, device="cuda")
             / K ** .5).to(dtype)
        wc = make_parity_weights(w, spec)
        vh = (True,) * t
        esel, coef, g = ops.decode_plan(spec, vh, vh, m_l, "cuda")
        wcat = torch.cat([w, unfold_parity(wc, t, r).permute(1, 0, 2)
                          .reshape(K, r * m_l)], dim=1)
        cdc_matmul.cdc_coded_matmul.variants.clear()
        ms = _time(lambda: cdc_matmul.cdc_coded_matmul(
            x, w, wc, "folded", t, r, g, esel, coef, vh), flush)
        lib = _time(lambda: torch.matmul(x, wcat), flush)
        e = w.element_size()
        emit(kernel="cdc_coded_matmul", gemm=name, r=r, rows=4, T=t,
             dtype=str(dtype), ms=ms, library_ms=lib,
             bound_ms=e * (t + r) * K * m_l / 3.35e12 * 1e3,
             variant=sorted(cdc_matmul.cdc_coded_matmul.variants))
        del w, wc, wcat
    time_encode_t12(emit, gen, flush)


def time_encode_t12(emit, gen, flush):
    """Kernel 4 at granite's w1 leaf at T = 12 (``ENCODE_T12``), r = 2
    folded, beside its bound (the shards read once, the parity written
    once) and torch.matmul of the generator over a contiguous copy of the
    shards."""
    from repro_torch.core.coding import generator_matrix
    from repro_torch.kernels import cdc_encode as enc
    L, k, m = ENCODE_T12
    t, r = 12, 2
    w = torch.randn((L, k, m), generator=gen, device="cuda") / k ** .5
    sh = w.view(L, k, t, m // t).permute(0, 2, 1, 3)
    g = generator_matrix(t, r)
    counts = getattr(enc.cdc_encode, "variants", {})   # (a parent's: none)
    counts.clear()
    ms = _time(lambda: enc.cdc_encode(sh, g, layout="folded"), flush, 10)
    variant = sorted(counts)
    flat = sh.contiguous().reshape(L, t, -1)
    gt = torch.as_tensor(g.astype(np.float32), device="cuda")
    lib = _time(lambda: torch.matmul(gt, flat), flush, 10)
    del flat
    emit(kernel="cdc_encode", leaf="w1", shape=[L, k, m], T=t, r=r,
         ms=ms, library_ms=lib,
         bound_ms=4.0 * sh.numel() * (t + r) / t / 3.35e12 * 1e3,
         variant=variant)


if __name__ == "__main__":
    sys.exit(main())
