#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (run from the repo root).

  python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):
  1. print the card's name and power limit; build the CUDA kernels from
     src/repro_torch/csrc (one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version on the card, at
     granite-3-8b's full-width shapes, under the all-valid mask and every
     single dead shard (float32, rtol = atol = 1e-4), plus an rmsnorm-fold
     case and a constructed argmax tie across two vocabulary tiles;
  3. serve granite-3-8b at full width (40 layers, d 4096, T=4, r=2 folded,
     float32, random weights from a seeded torch.Generator) through
     ServingEngine.generate: 4 requests, prompt 16, 16 new tokens, fault
     free, with shard 2 killed at step 4, and on the reference variant; the
     token streams must be identical and every fused round must launch the
     coded-GEMM kernel 200 times and the fused head once;
  4. time each kernel at its main-path shape with CUDA events beside its
     plain version, one library call and its bandwidth/compute bound.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

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
                k: int = K):
    from repro_torch.core.coded_layer import (CodedDenseSpec,
                                              make_parity_weights)
    from repro_torch.core.coding import CodeSpec
    spec = CodedDenseSpec(CodeSpec(T, R), layout=layout)
    x = torch.randn((rows, k), generator=gen, device="cuda")
    w = torch.randn((k, T * m_l), generator=gen, device="cuda") / k ** 0.5
    return spec, x, w, make_parity_weights(w, spec)


def _run_coded(x, w, wc, spec, valid, gamma=None, plain=False):
    """The kernel (or, with plain=True, its plain version on the same card
    tensors) behind ops.fused_coded_matmul, for one mask."""
    from repro_torch.kernels import cdc_matmul, ops
    vh = tuple(bool(v) for v in valid)
    m_l = w.shape[1] // T
    esel, coef, g = ops.decode_plan(spec, vh, vh, m_l, str(x.device))
    if plain:
        return cdc_matmul.coded_matmul_plain(x, w, wc, spec.layout, T, R, g,
                                             esel, coef, vh, gamma)
    return cdc_matmul.cdc_coded_matmul(x, w, wc, spec.layout, T, R, g, esel,
                                       coef, vh, gamma=gamma)


def _masks():
    yield (True,) * T
    for d in range(T):
        yield tuple(i != d for i in range(T))


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


def _head_views(w):
    w_shards = w.view(K, T, -1).permute(1, 0, 2)
    return w_shards, w_shards.sum(0).contiguous()


def check_fused_head(cfg) -> float:
    """Kernel 2 vs its plain version under every mask, and a tie across
    two vocabulary tiles that must resolve to the smaller id."""
    from repro_torch.kernels import cdc_decode, ref
    gen = torch.Generator(device="cuda").manual_seed(12)
    w = _head(cfg, gen)
    x = torch.randn((4, K), generator=gen, device="cuda")
    w_shards, pw = _head_views(w)
    worst = 0.0
    # every mask at the main path's 4 rows, and 12 rows (two row blocks)
    x12 = torch.randn((12, K), generator=gen, device="cuda")
    for xs, valid in [(x, m) for m in _masks()] + [(x12, (True,) * T)]:
        tok, vmax = cdc_decode.cdc_fused_head_argmax(xs, w_shards, pw, valid,
                                                     vocab=cfg.vocab)
        rtok, rmax = ref.fused_head_argmax_ref(
            xs, w_shards, pw, torch.tensor(valid), cfg.vocab)
        torch.cuda.synchronize()
        if not torch.equal(tok, rtok):
            raise AssertionError(f"fused head tokens {tok.tolist()} != "
                                 f"plain {rtok.tolist()} (mask {valid})")
        torch.testing.assert_close(vmax, rmax, **TOL)
        worst = max(worst, float((vmax - rmax).abs().max()))
    m_l = w.shape[1] // T
    # the same column twice, clearly the best for every row: once in an
    # EARLY tile of shard 1 and once in a LATE tile of shard 0, whose
    # global id (9000) is the smaller one
    col = torch.sign(x).mean(0) * 0.5
    ids = (1 * m_l + 10, 0 * m_l + 9000)
    for gid in ids:
        w[:, gid] = col
    w_shards, pw = _head_views(w)
    # masks that keep both tied shards alive: a rebuilt shard's column is
    # the parity minus the others, equal to the original only to rounding
    for valid in [m for m in _masks() if m[0] and m[1]]:
        tok, _ = cdc_decode.cdc_fused_head_argmax(x, w_shards, pw, valid,
                                                  vocab=cfg.vocab)
        rtok, _ = ref.fused_head_argmax_ref(x, w_shards, pw,
                                            torch.tensor(valid), cfg.vocab)
        torch.cuda.synchronize()
        if tok.tolist() != [min(ids)] * 4 or rtok.tolist() != [min(ids)] * 4:
            raise AssertionError(f"tie must resolve to id {min(ids)}: kernel "
                                 f"{tok.tolist()}, plain {rtok.tolist()}")
    log(f"kernel cdc_fused_head_argmax: {T + 2} cases equal tokens, max "
        f"within 1e-4 (max abs err {worst:.3e}); cross-tile tie -> id "
        f"{min(ids)}")
    return worst


# ------------------------------------------------------------ phase 3 ----

def serve_full_width(cfg) -> dict:
    from repro_torch.kernels import cdc_decode, cdc_matmul
    from repro_torch.models import TPCtx, build
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
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 16))}
    n_tok = 16

    def run(eng, fail_at=None):
        cdc_matmul.cdc_coded_matmul.launches = 0
        cdc_decode.cdc_fused_head_argmax.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        toks = eng.generate(batch, n_tok, fail_at=fail_at)
        torch.cuda.synchronize()
        ex = eng._executors[4]
        return {"tokens": toks, "seconds": time.perf_counter() - t,
                "k1": cdc_matmul.cdc_coded_matmul.launches,
                "k2": cdc_decode.cdc_fused_head_argmax.launches,
                "round_ms": list(ex.round_ms[-(n_tok - 1):]),
                "variants": ex.vstep.last_variant}

    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(model, params, scfg, use_fused=True)
    clean = run(eng)
    breakdown = profile_rounds(eng._executors[4], eng.valid,
                               float(np.median(clean["round_ms"])))
    overlapped = run_overlapped(eng.stepper, batch, n_tok)
    if not np.array_equal(overlapped["tokens"], clean["tokens"]):
        raise AssertionError("overlapped executor tokens differ:\n"
                             f"{overlapped['tokens']}\nvs\n{clean['tokens']}")
    faulty = run(eng, fail_at={4: 2})
    del eng
    ref_eng = ServingEngine(model, params, scfg, use_fused=False)
    reference = run(ref_eng)
    del ref_eng
    peak = torch.cuda.max_memory_allocated()
    rounds = n_tok - 1
    for name, res in (("fault-free", clean), ("shard 2 dead at step 4",
                                              faulty)):
        if res["k1"] != 200 * rounds or res["k2"] != rounds:
            raise AssertionError(
                f"{name}: {res['k1']} coded-GEMM and {res['k2']} head "
                f"launches over {rounds} fused rounds; expected "
                f"{200 * rounds} and {rounds}")
    if reference["k1"] or reference["k2"]:
        raise AssertionError("the reference variant launched a kernel")
    for name, res in (("erasure", faulty), ("reference", reference)):
        if not np.array_equal(res["tokens"], clean["tokens"]):
            raise AssertionError(
                f"{name} run tokens differ from the fault-free fused run:\n"
                f"{res['tokens']}\nvs\n{clean['tokens']}")
    toks = clean["tokens"]
    if toks.shape != (4, n_tok) or toks.min() < 0 or toks.max() >= cfg.vocab:
        raise AssertionError(f"bad token stream {toks}")
    med = float(np.median(clean["round_ms"]))
    log(f"served 4 requests x {n_tok} tokens: identical streams fault-free, "
        f"with shard 2 erased at step 4, and on the reference variant")
    log("first stream:", toks[0].tolist())
    log(f"overlapped executor (dispatch N, then harvest N-1): same "
        f"streams, {overlapped['period_ms']:.3f} ms per round (wall time "
        f"of {n_tok} steps / {n_tok})")
    log(f"launches per fused round: {clean['k1'] // rounds} coded-GEMM + "
        f"{clean['k2'] // rounds} fused head")
    log(f"fused round median {med:.3f} ms (erasure run "
        f"{float(np.median(faulty['round_ms'])):.3f} ms, reference variant "
        f"{float(np.median(reference['round_ms'])):.3f} ms); "
        f"{4 * 1e3 / med:.1f} tokens/s at 4 slots; "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB")
    return {"k1": clean["k1"], "k2": clean["k2"], "breakdown": breakdown}


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
    return {"device_ms": device_ms, "round_ms": round_ms,
            "top": [{"kernel": k[:90], "ms": ms, "count": c}
                    for k, ms, c in rows[:10]]}


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


def _bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_b, t_o = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def time_kernels(cfg, rows: int = 4) -> list[dict]:
    from repro_torch.core.coded_layer import unfold_parity
    from repro_torch.kernels import cdc_decode, ref
    gen = torch.Generator(device="cuda").manual_seed(13)
    scratch = torch.empty(64 * 2 ** 20, device="cuda")   # 256 MB > L2
    flush = scratch.zero_
    out = []
    for name, m_l in (("w1", 3200), ("wq", 1024), ("wk", 256)):
        spec, x, w, wc = _coded_case(m_l, rows, "folded", gen)
        valid = (True,) * T
        wcat = torch.cat([w, unfold_parity(wc, T, R).permute(1, 0, 2)
                          .reshape(K, R * m_l)], dim=1)
        ms = _time(lambda: _run_coded(x, w, wc, spec, valid), flush)
        plain = _time(lambda: _run_coded(x, w, wc, spec, valid, plain=True),
                      flush)
        lib = _time(lambda: torch.matmul(x, wcat), flush)
        nbytes = 4 * (rows * K + (T + R) * K * m_l + rows * T * m_l
                      + 2 * m_l)
        bound, by = _bound(nbytes, 2.0 * rows * K * m_l * (T + R))
        out.append({"gemm": name, "rows": rows, "m_l": m_l, "ms": ms,
                    "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                    "bound_by": by})
        log(f"cdc_coded_matmul {name} [rows={rows}, k={K}, m_l={m_l}]: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library matmul "
            f"{lib:.4f} ms, bound {bound:.4f} ms ({by})")
    w = _head(cfg, gen)
    w_shards, pw = _head_views(w)
    m_l = w_shards.shape[2]
    x = torch.randn((rows, K), generator=gen, device="cuda")
    valid = (True,) * T
    ms = _time(lambda: cdc_decode.cdc_fused_head_argmax(
        x, w_shards, pw, valid, vocab=cfg.vocab), flush)
    vt = torch.tensor(valid)
    plain = _time(lambda: ref.fused_head_argmax_ref(x, w_shards, pw, vt,
                                                    cfg.vocab), flush)
    wcat = torch.cat([w, pw], dim=1)
    lib = _time(lambda: torch.matmul(x, wcat), flush)
    nbytes = 4 * (rows * K + (T + 1) * K * m_l + 2 * rows)
    bound, by = _bound(nbytes, 2.0 * rows * K * m_l * (T + 1))
    out.append({"gemm": "lm_head", "rows": rows, "m_l": m_l, "ms": ms,
                "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                "bound_by": by})
    log(f"cdc_fused_head_argmax [b={rows}, k={K}, m_l={m_l}]: kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, library matmul {lib:.4f} ms, "
        f"bound {bound:.4f} ms ({by})")
    return out


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
    for name, rep in report.items():
        for line in rep["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    cfg = get_arch("granite-3-8b")
    err1 = check_coded_matmul()
    err2 = check_fused_head(cfg)
    served = serve_full_width(cfg)
    timed = time_kernels(cfg)
    w1 = timed[0]
    head = timed[-1]
    kernels = [
        {"name": "cdc_coded_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/cdc_coded_matmul.cu",
         "replaces": "src/repro/kernels/cdc_matmul.py:130",
         "launches": served["k1"], "max_abs_err": err1,
         "ms": w1["ms"], "plain_ms": w1["plain_ms"],
         "bound_ms": w1["bound_ms"], "bound_by": w1["bound_by"],
         "library_ms": w1["library_ms"]},
        {"name": "cdc_fused_head_argmax", "route": "cuda",
         "source": "src/repro_torch/csrc/cdc_fused_head.cu",
         "replaces": "src/repro/kernels/cdc_decode.py:138",
         "launches": served["k2"], "max_abs_err": err2,
         "ms": head["ms"], "plain_ms": head["plain_ms"],
         "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
         "library_ms": head["library_ms"]},
    ]
    log(card)
    log(json.dumps({"shapes": timed, "round": served["breakdown"]}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
