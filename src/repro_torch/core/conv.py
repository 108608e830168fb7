"""Convolution via the paper's GEMM transformation (Fig. 4) and
channel-split CDC.

The paper codes a convolution below the framework, at the GEMM: the
input is unrolled so that O = W[K, F*F*C] @ I[F*F*C, W*H] (Eq. 4).
Channel splitting divides W along K (the filter/output axis), the same
algebra as a fully-connected layer's output split (Fig. 8), so
``coded_matmul`` runs unchanged on the unrolled weights. Tensors are laid
out as the reference lays them out: inputs [N, H, W, C], filters [F, F, C,
K], outputs [N, Ho, Wo, K].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.coded_layer import CodedDenseSpec, coded_matmul

__all__ = ["im2col", "conv2d_gemm", "coded_conv2d"]


def im2col(x: torch.Tensor, f: int, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """Unroll input patches (paper Fig. 4a): x [N, H, W, C] -> [N, Ho*Wo,
    F*F*C], each patch's taps row-major with the channels innermost."""
    n, h, w, c = x.shape
    if padding == "SAME":
        lo, hi = (f - 1) // 2, f // 2
        x = F.pad(x, (0, 0, lo, hi, lo, hi))
        ho, wo = -(-h // stride), -(-w // stride)
    else:
        ho = (h - f) // stride + 1
        wo = (w - f) // stride + 1
    span_h, span_w = (ho - 1) * stride + 1, (wo - 1) * stride + 1
    cols = [x[:, di:di + span_h:stride, dj:dj + span_w:stride, :]
            for di in range(f) for dj in range(f)]
    patches = torch.stack(cols, dim=3)  # [N, Ho, Wo, F*F, C]
    return patches.reshape(n, ho * wo, f * f * c)


def conv2d_gemm(x: torch.Tensor, filters: torch.Tensor, stride: int = 1,
                padding: str = "SAME") -> torch.Tensor:
    """A convolution as one GEMM (paper Eq. 4). filters: [F, F, C, K]; x:
    [N, H, W, C] -> [N, Ho, Wo, K]."""
    f, _, c, k = filters.shape
    n, h, w, _ = x.shape
    cols = im2col(x, f, stride, padding)  # [N, P, F*F*C]
    out = cols @ filters.reshape(f * f * c, k)  # [N, P, K]
    ho = cols.shape[1] // (-(-w // stride)) if padding == "SAME" else \
        (h - f) // stride + 1
    return out.reshape(n, ho, cols.shape[1] // ho, k)


def coded_conv2d(x: torch.Tensor, filters: torch.Tensor,
                 w_cdc: torch.Tensor | None, spec: CodedDenseSpec,
                 valid=None, stride: int = 1, padding: str = "SAME",
                 **kw) -> torch.Tensor:
    """Channel-split convolution with CDC over the filter axis K: the
    unrolled GEMM through ``coded_matmul`` (``kw`` passes on to it), so a
    dead filter shard is recovered from the parity. ``w_cdc`` comes from
    ``make_parity_weights(filters.reshape(F*F*C, K), spec)``, offline, as
    a fully-connected layer's does."""
    f, _, c, k = filters.shape
    n, h, w, _ = x.shape
    cols = im2col(x, f, stride, padding)  # [N, P, F*F*C]
    out = coded_matmul(cols, filters.reshape(f * f * c, k), w_cdc, spec,
                       valid, **kw)  # [N, P, K]
    ho = -(-h // stride) if padding == "SAME" else (h - f) // stride + 1
    return out.reshape(n, ho, out.shape[1] // ho, k)
