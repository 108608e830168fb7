"""RMSNorm of each row: x * rsqrt(mean(x^2) + eps) * gamma, float32 math.

``rmsnorm`` flattens the leading dimensions of x [..., d] (rows may sit
at any stride, e.g. the last position of each sequence) and, on a CUDA
tensor, launches the kernel in ``csrc/rmsnorm.cu`` (one launch per call)
with the plan ``rmsnorm_plan``; on a CPU tensor it runs the plain version
``ref.rmsnorm_ref``. The
serving round's norms (``models.common.rmsnorm``) go through it on the
card. The default eps is the reference kernel's 1e-6; the models pass
their ``norm_eps``.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import accounting, build, ref

THREADS = 256        # threads a row (RMS_THREADS in csrc/rmsnorm.cu)
MAX_VALUES = 128     # values of the row a thread holds (RMS_MAX_VALUES)


def nv_options(bf16: bool) -> tuple[int, ...]:
    """16-byte vectors a thread of the register instantiations: powers of
    two up to 32 whose values (4 float32 or 8 bf16 a vector) stay within
    MAX_VALUES. 0, the scalar instantiation, is not among them."""
    return tuple(nv for nv in (1, 2, 4, 8, 16, 32)
                 if nv * (8 if bf16 else 4) <= MAX_VALUES)


def rmsnorm_plan(d: int, ldx: int, bf16: bool, ptr_aligned: bool = True
                 ) -> int:
    """The 16-byte vectors a thread of the instantiation a call takes: the
    fewest that hold a row of d when d, the row stride ``ldx`` and the
    bases (``ptr_aligned``) are whole vectors; else, or when no register
    count holds d, 0 (the scalar instantiation)."""
    e = 8 if bf16 else 4
    if ptr_aligned and d % e == 0 and ldx % e == 0:
        for nv in nv_options(bf16):
            if nv * THREADS * e >= d:
                return nv
    return 0


def variant(nv: int) -> str:
    return "scalar" if nv == 0 else f"nv{nv}"


def _lib():
    fn = build.load("rmsnorm").cdc_rmsnorm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, ctypes.c_longlong, ctypes.c_float, i,
                       i, p]
        fn.restype = i
    return fn


@accounting.costed("rmsnorm")
def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-6
            ) -> torch.Tensor:
    """x [..., d] (float32 or bf16), gamma [d] -> x's shape and dtype."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, gamma, eps)
    who = "rmsnorm"
    if x.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {x.device}")
    bf16 = build.bf16_flag(x.dtype, who)
    d = x.shape[-1]
    if not (gamma.dtype == torch.float32 and tuple(gamma.shape) == (d,)
            and gamma.is_contiguous() and gamma.device == x.device):
        raise ValueError(f"{who}: gamma {tuple(gamma.shape)} {gamma.dtype} "
                         f"must be a contiguous float32 [{d}] on {x.device}")
    xf = x.reshape(-1, d)           # a view where x's rows allow one
    if xf.stride(-1) != 1 and d > 1:
        raise ValueError(f"{who}: x {tuple(x.shape)} has no unit stride "
                         f"along d")
    out = torch.empty(xf.shape, dtype=x.dtype, device=x.device)
    if xf.numel() == 0:
        return out.reshape(x.shape)
    ldx = xf.stride(0) if xf.shape[0] > 1 else d
    ptr_ok = (xf.data_ptr() | out.data_ptr() | gamma.data_ptr()) % 16 == 0
    nv = rmsnorm_plan(d, ldx, bool(bf16), ptr_ok)
    err = _lib()(xf.data_ptr(), gamma.data_ptr(), out.data_ptr(),
                 xf.shape[0], d, ldx, eps, bf16, nv,
                 build.raw_stream(x.device))
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed: cudaError {err} "
                           f"(nv {nv})")
    rmsnorm.launches += 1
    rmsnorm.variants[variant(nv)] += 1
    return out.reshape(x.shape)


rmsnorm.launches = 0
rmsnorm.variants = collections.Counter()   # launches per instantiation
