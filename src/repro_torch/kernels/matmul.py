"""Blocked GEMM with float32 accumulation: x [m, k] @ w [k, n].

``matmul`` launches the kernels in ``csrc/matmul.cu`` on a CUDA tensor and
runs the plain version ``ref.matmul_ref`` on a CPU tensor. Any m, k and n
(no block-multiple padding); float32 or bf16 in, the result cast to
``out_dtype`` (x's dtype by default). ``matmul_plan`` picks the path: few
rows (m <= 16, float32 in) stream w through the mainloop of
``csrc/stream_tile.cuh`` with k split across blocks; everything else takes
64 x 32 output tiles. Shapes the copy engine cannot take run the same
kernels copying otherwise: the few-rows path granule by granule by
cp.async, the square path by ordinary loads. Its caller is the
coded-overhead study (``launch.coded_overhead.run_kernels``), as in the
reference.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import accounting, build, ref, stream_plan
from repro_torch.kernels.cdc_matmul import _n_sm, _tile_counters

ROWS_MAX = 16             # the few-rows path's largest m
SQ_BM, SQ_BN = 64, 32     # the square path's output tile (csrc/matmul.cu)


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    path: str                               # "rows" or "square"
    m: int
    n: int
    k: int
    aligned: bool                           # bulk copies, or not
    stream: stream_plan.StreamPlan | None   # the rows path's plan

    @property
    def variant(self) -> str:
        tail = self.stream.variant if self.stream else \
            ("async" if self.aligned else "loads")
        return f"{self.path}-{tail}"

    def units(self):
        """(c0, width, r0, kb0, kb1) of every block in launch order."""
        if self.stream is not None:
            return self.stream.units()
        return [(c0, min(SQ_BN, self.n - c0), r0, 0, self.k)
                for r0 in range(0, self.m, SQ_BM)
                for c0 in range(0, self.n, SQ_BN)]


@functools.lru_cache(maxsize=256)
def matmul_plan(m: int, n: int, k: int, in_bf16: bool, n_sm: int,
                occupancy: int, ptr_aligned: bool = True) -> MatmulPlan:
    """The path and launch plan of one ``matmul`` call. The copy engine
    needs rows in 16-byte units (n, and k for the square path's x rows,
    multiples of 4 floats), float32 storage and 16-byte aligned bases
    (``ptr_aligned``). ``occupancy`` is the few-rows kernel's resident
    blocks per SM."""
    if m <= ROWS_MAX and not in_bf16:
        aligned = ptr_aligned and n % 4 == 0
        sp = stream_plan.plan(m, k, n, 1, 1, n_sm * occupancy, aligned)
        return MatmulPlan("rows", m, n, k, aligned, sp)
    aligned = ptr_aligned and not in_bf16 and n % 4 == 0 and k % 4 == 0
    return MatmulPlan("square", m, n, k, aligned, None)


def _lib(name: str, argtypes):
    fn = getattr(build.load("matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_p, _i = ctypes.c_void_p, ctypes.c_int
_ROWS_ARGS = [_p] * 5 + [_i] * 11 + [_p]
_SQUARE_ARGS = [_p] * 3 + [_i] * 6 + [_p]


def _prepare(x: torch.Tensor, w: torch.Tensor, out_dtype, ptr_ok: bool):
    """Check one call signature and fix its plan: (plan, its variant, C
    function, in_bf16, out_bf16); no plan for an empty product. Raises on
    what the kernels do not take."""
    who = "matmul"
    if x.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {x.device}")
    in_bf16 = build.bf16_flag(x.dtype, who)
    out_bf16 = build.bf16_flag(out_dtype, who)
    if not (x.ndim == 2 and w.ndim == 2 and x.shape[1] == w.shape[0]
            and w.dtype == x.dtype and w.device == x.device
            and x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{who}: x {tuple(x.shape)} {x.dtype} / w "
                         f"{tuple(w.shape)} {w.dtype}: want contiguous "
                         f"[m, k] @ [k, n] of one dtype")
    (m, k), n = x.shape, w.shape[1]
    if m * n * k == 0:
        return None, None, None, in_bf16, out_bf16
    occ = build.occupancy(
        "matmul", "cdc_matmul_rows_occupancy", stream_plan.row_block(m, n),
        int(ptr_ok and n % 4 == 0), out_bf16) \
        if m <= ROWS_MAX and not in_bf16 else 1
    plan = matmul_plan(m, n, k, bool(in_bf16), _n_sm(x.device), occ, ptr_ok)
    fn = _lib("cdc_matmul_rows", _ROWS_ARGS) if plan.stream is not None \
        else _lib("cdc_matmul_square", _SQUARE_ARGS)
    return plan, plan.variant, fn, in_bf16, out_bf16


_prepared: dict[tuple, tuple] = {}


@accounting.costed("matmul")
def matmul(x: torch.Tensor, w: torch.Tensor, *, out_dtype=None
           ) -> torch.Tensor:
    """x [m, k] @ w [k, n] -> [m, n] in ``out_dtype``."""
    dev = x.device
    if dev.type in build.PLAIN_DEVICES:
        return ref.matmul_ref(x, w, out_dtype)
    build.refuse_grad("matmul", x, w)
    out_dtype = out_dtype or x.dtype
    xp, wp = x.data_ptr(), w.data_ptr()
    ptr_ok = (xp | wp) % 16 == 0
    key = (x.shape, w.shape, x.dtype, w.dtype, out_dtype, dev, w.device,
           x.is_contiguous(), w.is_contiguous(), ptr_ok)
    prep = _prepared.get(key)
    if prep is None:
        prep = _prepared[key] = _prepare(x, w, out_dtype, ptr_ok)
    plan, variant, fn, in_bf16, out_bf16 = prep
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if plan is None:
        return out.zero_()
    stream = build.raw_stream(dev)
    sp = plan.stream
    if sp is not None:
        ws = torch.empty((sp.ksplit if sp.ksplit > 1 else 0, m, n),
                         dtype=torch.float32, device=dev)
        sem = _tile_counters(dev, sp.counters)
        err = fn(xp, wp, out.data_ptr(), ws.data_ptr(), sem.data_ptr(), m,
                 n, k, out_bf16, sp.rb, int(sp.aligned), sp.bn, sp.nrb,
                 sp.ksplit, sp.kchunk, sp.ks, stream)
    else:
        err = fn(xp, wp, out.data_ptr(), m, n, k, in_bf16, out_bf16,
                 int(plan.aligned), stream)
    if err != 0:
        raise RuntimeError(f"matmul kernel launch failed: cudaError {err} "
                           f"(plan {plan})")
    matmul.launches += 1
    matmul.variants[variant] += 1
    return out


matmul.launches = 0
matmul.variants = collections.Counter()   # launches per variant
