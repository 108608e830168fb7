"""RMSNorm of each row: x * rsqrt(mean(x^2) + eps) * gamma, float32 math.

``rmsnorm`` flattens the leading dimensions of x [..., d] (rows may sit
at any stride, e.g. the last position of each sequence) and, on a CUDA
tensor, launches the kernel in ``csrc/rmsnorm.cu`` (one launch per call);
on a CPU tensor it runs the plain version ``ref.rmsnorm_ref``. The
serving round's norms (``models.common.rmsnorm``) go through it on the
card. The default eps is the reference kernel's 1e-6; the models pass
their ``norm_eps``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref


def _lib():
    fn = build.load("rmsnorm").cdc_rmsnorm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, ctypes.c_longlong, ctypes.c_float, i,
                       p]
        fn.restype = i
    return fn


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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()(xf.data_ptr(), gamma.data_ptr(), out.data_ptr(),
                 xf.shape[0], d, xf.stride(0) if xf.shape[0] > 1 else d, eps,
                 bf16, stream)
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed: cudaError {err}")
    rmsnorm.launches += 1
    return out.reshape(x.shape)


rmsnorm.launches = 0
