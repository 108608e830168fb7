"""Blocked GEMM with float32 accumulation: x [m, k] @ w [k, n].

``matmul`` launches the kernel in ``csrc/matmul.cu`` on a CUDA tensor and
runs the plain version ``ref.matmul_ref`` on a CPU tensor. Any m, k and n
(no block-multiple padding); float32 or bf16 in, the result cast to
``out_dtype`` (x's dtype by default). Its caller is the coded-overhead
study (``launch.coded_overhead.run_kernels``), as in the reference.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref


def _lib():
    fn = build.load("matmul").cdc_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, p]
        fn.restype = i
    return fn


def matmul(x: torch.Tensor, w: torch.Tensor, *, out_dtype=None
           ) -> torch.Tensor:
    """x [m, k] @ w [k, n] -> [m, n] in ``out_dtype``."""
    if x.device.type == "cpu":
        return ref.matmul_ref(x, w, out_dtype)
    who = "matmul"
    if x.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {x.device}")
    out_dtype = out_dtype or x.dtype
    in_bf16 = build.bf16_flag(x.dtype, who)
    out_bf16 = build.bf16_flag(out_dtype, who)
    if not (x.ndim == 2 and w.ndim == 2 and x.shape[1] == w.shape[0]
            and w.dtype == x.dtype and w.device == x.device
            and x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{who}: x {tuple(x.shape)} {x.dtype} / w "
                         f"{tuple(w.shape)} {w.dtype}: want contiguous "
                         f"[m, k] @ [k, n] of one dtype")
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                 in_bf16, out_bf16, stream)
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed: cudaError {err}")
    matmul.launches += 1
    return out


matmul.launches = 0
