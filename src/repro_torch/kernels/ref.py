"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function repeats its kernel's arithmetic in float32; the CPU path of
every wrapper runs these, and the chip checks hold each kernel against
them. The select-versus-multiply choice for dead shards follows the
reference oracle of each function as written.
"""
from __future__ import annotations

import torch


def matmul_ref(x: torch.Tensor, w: torch.Tensor, out_dtype=None
               ) -> torch.Tensor:
    """x [m, k] @ w [k, n] accumulated in float32, cast to ``out_dtype``
    (x's dtype by default)."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)) \
        .to(out_dtype or x.dtype)


def cdc_decode_ref(y_shards: torch.Tensor, parity: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """r=1 recovery, paper Eq. 12, with dead shards zeroed by MULTIPLY as
    the reference oracle writes it (a NaN in a dead shard propagates).
    y [T, m, n], parity [m, n], valid [T] bool -> [T, m, n], y's dtype."""
    vmask = valid.to(device=y_shards.device,
                     dtype=torch.float32)[:, None, None]
    y = y_shards.to(torch.float32) * vmask
    missing = parity.to(torch.float32) - y.sum(0)
    out = y + (1.0 - vmask) * missing[None]
    return out.to(y_shards.dtype)


def cdc_encode_ref(w_shards: torch.Tensor, gen: torch.Tensor
                   ) -> torch.Tensor:
    """Offline parity encode: [T, k, n] shards x [r, T] generator ->
    [r, k, n], accumulated in float32 and cast to the shards' dtype."""
    acc = torch.tensordot(gen.to(torch.float32), w_shards.to(torch.float32),
                          dims=([1], [0]))
    return acc.to(w_shards.dtype)


def fused_head_argmax_ref(x: torch.Tensor, w_shards: torch.Tensor,
                          parity_w: torch.Tensor, valid: torch.Tensor,
                          vocab: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused coded head: T shard GEMMs + the sum-parity GEMM + Eq. 12
    (dead shards zeroed by MULTIPLY, as the reference oracle does) + argmax
    over the merged logical vocabulary. x [b, k], w_shards [T, k, m_l],
    parity_w [k, m_l], valid [T] bool. Returns (token int32 [b], max [b])."""
    xf = x.to(torch.float32)
    y = torch.matmul(xf[None], w_shards.to(torch.float32))      # [T, b, m_l]
    p = xf @ parity_w.to(torch.float32)                         # [b, m_l]
    vmask = valid.to(device=y.device, dtype=torch.float32)[:, None, None]
    yz = y * vmask
    missing = p - yz.sum(0)
    rec = yz + (1.0 - vmask) * missing[None]
    merged = rec.movedim(0, -2).reshape(x.shape[0], -1)[:, :vocab]
    # torch.argmax returns the first maximal index, the same tie rule as
    # jnp.argmax: ties go to the smallest vocabulary id
    return (torch.argmax(merged, dim=-1).to(torch.int32),
            merged.max(dim=-1).values)


def _eq12_combine_ref(y: torch.Tensor, p: torch.Tensor, gen: torch.Tensor,
                      valid: torch.Tensor, esel: torch.Tensor,
                      coef: torch.Tensor) -> torch.Tensor:
    """Eq. 12 tail of the in-body kernel: zero dead shards by SELECT,
    rebuild the missing one from the per-column equation ``esel`` scaled by
    ``coef``, emit the merged [rows, T, m_l] layout. y: [T, rows, m_l],
    p: [r, rows, m_l], both float32."""
    vmask = valid.to(y.device)[:, None, None]
    zero = torch.zeros((), device=y.device)
    yz = torch.where(vmask, y, zero)
    residual = p - torch.tensordot(gen.to(torch.float32), yz,
                                   dims=([1], [0]))    # [r, rows, m_l]
    onehot = torch.arange(p.shape[0], device=y.device)[:, None] \
        == esel.to(y.device)[None, :]                            # [r, m_l]
    pick = torch.where(onehot[:, None, :], residual, zero).sum(0)
    missing = pick * coef.to(device=y.device, dtype=torch.float32)[None, :]
    out = torch.where(vmask, yz, missing[None])
    return out.movedim(0, 1)                           # [rows, T, m_l]


def cdc_coded_matmul_ref(x: torch.Tensor, w_shards: torch.Tensor,
                         parity_w: torch.Tensor, gen: torch.Tensor,
                         esel: torch.Tensor, coef: torch.Tensor,
                         valid: torch.Tensor, *,
                         gamma: torch.Tensor | None = None,
                         eps: float = 1e-5, out_dtype=None) -> torch.Tensor:
    """(rmsnorm?) + T shard GEMMs + r parity GEMMs + Eq. 12 decode + merge,
    all float32. x [rows, k], w_shards [T, k, m_l], parity_w [r, k, m_l]
    (unfolded). Returns merged [rows, T, m_l]."""
    xf = x.to(torch.float32)
    if gamma is not None:
        var = (xf * xf).mean(-1, keepdim=True)
        xf = xf * torch.rsqrt(var + eps) * gamma.to(torch.float32)[None]
    y = torch.matmul(xf[None], w_shards.to(torch.float32))
    p = torch.matmul(xf[None], parity_w.to(torch.float32))
    out = _eq12_combine_ref(y, p, gen, valid, esel, coef)
    return out.to(out_dtype or x.dtype)


def cdc_decode_merge_ref(ys: torch.Tensor, parity: torch.Tensor,
                         gen: torch.Tensor, esel: torch.Tensor,
                         coef: torch.Tensor, valid: torch.Tensor
                         ) -> torch.Tensor:
    """Eq. 12 decode + merge of already-computed shard outputs ys
    [T, rows, m_l] with UNFOLDED parity [r, rows, m_l] (dead shards zeroed
    by SELECT). Returns merged [rows, T, m_l] in ys' dtype."""
    out = _eq12_combine_ref(ys.to(torch.float32), parity.to(torch.float32),
                            gen, valid, esel, coef)
    return out.to(ys.dtype)


def rmsnorm_ref(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
                ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * gamma.to(torch.float32)).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of ``rmsnorm_ref`` at (x, gamma) for the output gradient
    dy, in float32: dx = rstd * (dy * gamma) - x * rstd^3 * mean(dy *
    gamma * x), dgamma = the sum over rows of dy * x * rstd. Returns (dx
    in x's dtype, dgamma [d] float32)."""
    xf, dyf = x.to(torch.float32), dy.to(torch.float32)
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    dyg = dyf * gamma.to(torch.float32)
    dx = rstd * dyg - xf * rstd ** 3 * (dyg * xf).mean(-1, keepdim=True)
    dgamma = (dyf * xf * rstd).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dgamma
