"""CDC-coded column-parallel (output-split) GEMM.

A coded dense layer owns
  w      [k, m]              the ordinary weight (T column shards of m_l)
  w_cdc  [T, k, r*m_l/T]     folded parity weights (slot-major, staggered), or
         [r, k, m_l]         dedicated parity weights (the paper's layout)
with m_l = m / T, computed offline from w. Stacked layer weights carry a
leading [L] axis. All masks are host-side bool [T] arrays or CPU tensors:
the erasure pattern is known on the host before a GEMM runs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import coding
from repro_torch.core.coding import (CodeSpec, erased_first,
                                     generator_tensor, host_mask)

__all__ = [
    "CodedDenseSpec", "pad_for_code", "make_parity_weights",
    "fold_parity_slots", "unfold_parity", "folded_slot_map", "coded_matmul",
    "decode_folded", "decode_and_merge", "merge_shards",
]


@dataclasses.dataclass(frozen=True)
class CodedDenseSpec:
    """Static description of one coded GEMM."""

    code: CodeSpec
    layout: str = "folded"  # "folded" | "dedicated"

    def __post_init__(self):
        if self.layout not in ("folded", "dedicated"):
            raise ValueError(self.layout)

    @property
    def max_device_failures(self) -> int:
        if self.code.n_parity == 0:
            return 0
        if self.layout == "dedicated":
            return self.code.n_parity
        return self.code.n_parity // 2


def pad_for_code(m: int, n_shards: int, align: int = 8) -> int:
    """The output dim rounded up so that m % (T * T * align) == 0: each
    shard's width splits into T aligned parity slices."""
    q = n_shards * n_shards * align
    return ((m + q - 1) // q) * q


def _bcast_mask(valid, ndim: int, device) -> torch.Tensor:
    v = torch.as_tensor(host_mask(valid), device=device)
    return v.reshape((v.shape[0],) + (1,) * (ndim - 1))


def folded_slot_map(T: int, r: int) -> np.ndarray:
    """slot_map[j, s] = device slot holding slice s of parity j (staggered:
    a dead device erases at most one parity equation per output column)."""
    j = np.arange(r)[:, None]
    s = np.arange(T)[None, :]
    return (s + j + 1) % T


def fold_parity_slots(parity: torch.Tensor, T: int) -> torch.Tensor:
    """[r, k, m_l] -> [T, k, r*w] slot-major staggered layout, w = m_l/T.
    Slot d holds, at columns j*w:(j+1)*w, slice (d - j - 1) % T of parity j."""
    r, k, m_l = parity.shape
    if m_l % T:
        raise ValueError(f"shard width {m_l} not divisible by T={T}")
    w = m_l // T
    out = parity.new_empty((T, k, r * w))
    for d in range(T):
        for j in range(r):
            s = (d - j - 1) % T
            out[d, :, j * w:(j + 1) * w] = parity[j, :, s * w:(s + 1) * w]
    return out


def unfold_parity(p_slots: torch.Tensor, T: int, r: int) -> torch.Tensor:
    """Inverse of the slot layout for outputs:
    [T, ..., r*w] -> [r, ..., m_l]."""
    w = p_slots.shape[-1] // r
    smap = folded_slot_map(T, r)
    return torch.stack([
        torch.cat([p_slots[int(smap[j, s])][..., j * w:(j + 1) * w]
                   for s in range(T)], dim=-1)
        for j in range(r)])


def make_parity_weights(w: torch.Tensor, spec: CodedDenseSpec
                        ) -> torch.Tensor:
    """Offline encode. w: [k, m] -> dedicated [r, k, m_l] or folded slots
    [T, k, r*m_l/T]; stacked [L, k, m] -> the same with a leading [L].
    Runs ``ops.cdc_encode`` on a view of w's T column shards (no copy): the
    encode kernel on a CUDA tensor (one launch per leaf), its plain version
    one layer at a time on a CPU tensor."""
    from repro_torch.kernels import ops  # deferred: ops imports us
    code = spec.code
    T = code.n_shards
    m = w.shape[-1]
    if m % T:
        raise ValueError(f"output dim {m} not divisible by T={T}; pad "
                         f"with pad_for_code() first")
    # [(L,) k, m] -> [(L,) T, k, m_l] view
    shards = w.reshape(w.shape[:-1] + (T, m // T)).movedim(-2, -3)
    return ops.cdc_encode(shards, code.generator, layout=spec.layout)


def merge_shards(ys: torch.Tensor) -> torch.Tensor:
    """[T, ..., m_l] stacked shard outputs -> merged [..., T*m_l]."""
    y = ys.movedim(0, -2)
    return y.reshape(y.shape[:-2] + (y.shape[-2] * y.shape[-1],))


def _shardwise_matmul(x: torch.Tensor, w_stacked: torch.Tensor
                      ) -> torch.Tensor:
    """y[d] = x @ w_stacked[d];  x: [..., k], w: [D, k, c] -> [D, ..., c]."""
    lead = x.shape[:-1]
    y = torch.matmul(x.reshape(1, -1, x.shape[-1]), w_stacked)
    return y.reshape((w_stacked.shape[0],) + lead + (w_stacked.shape[-1],))


def decode_and_merge(ys: torch.Tensor, parity: torch.Tensor | None,
                     spec: CodedDenseSpec, valid, *, valid_parity=None,
                     use_fused: bool = False) -> torch.Tensor:
    """Recovery + merge of already-computed shard outputs.

    ys: [T, ..., m_l]; parity: [r, ..., m_l] (dedicated) or [T, ..., r*w]
    slots (folded); None => plain merge. Erased entries may hold garbage:
    they are zeroed by select before the decode. ``use_fused`` routes
    through ``kernels.ops.fused_decode_merge`` (the decode-and-merge
    kernel on a CUDA tensor, its plain version on a CPU tensor; 2+ dead
    shards come back here); the default is the reference path.
    """
    code = spec.code
    if parity is None or code.n_parity == 0 or valid is None:
        return merge_shards(ys)
    if use_fused:
        from repro_torch.kernels import ops  # deferred: ops imports us
        return ops.fused_decode_merge(ys, parity, spec, valid,
                                      valid_parity=valid_parity)
    if valid_parity is None:
        valid_parity = valid
    zero = torch.zeros((), dtype=ys.dtype, device=ys.device)
    ys = torch.where(_bcast_mask(valid, ys.ndim, ys.device), ys, zero)
    if spec.layout == "dedicated":
        rec = coding.decode_outputs(ys, parity, host_mask(valid), code)
    else:
        p_slots = torch.where(
            _bcast_mask(valid_parity, parity.ndim, parity.device), parity,
            torch.zeros((), dtype=parity.dtype, device=parity.device))
        rec = decode_folded(ys, p_slots, valid, code,
                            valid_parity=valid_parity)
    return merge_shards(rec)


def coded_matmul(x: torch.Tensor, w: torch.Tensor,
                 w_cdc: torch.Tensor | None, spec: CodedDenseSpec,
                 valid=None, *, valid_parity=None,
                 use_fused: bool = False,
                 fused_decode: bool = False) -> torch.Tensor:
    """Output-split GEMM with CDC protection (paper Eq. 7/11 + recovery 12).

    x: [..., k]; w: [k, m]; w_cdc: parity weights (None => uncoded);
    valid: [T] host mask (None => all valid). ``use_fused`` routes through
    ``kernels.ops.fused_coded_matmul`` (the coded-GEMM kernel on a CUDA
    tensor, its plain version on a CPU tensor). Otherwise x @ w and the
    parity products run here, and ``fused_decode`` decodes and merges
    them through ``decode_and_merge(use_fused=True)``. Returns [..., m].
    """
    code = spec.code
    T = code.n_shards
    if w_cdc is not None and code.n_parity > 0 and valid is not None \
            and use_fused:
        from repro_torch.kernels import ops  # deferred: ops imports us
        return ops.fused_coded_matmul(x, w, w_cdc, spec, valid,
                                      valid_parity=valid_parity)
    k, m = w.shape
    # x @ w computes every shard's columns at once; viewing its columns
    # as [T, m_l] gives the stacked shard outputs without copying w
    y = x @ w
    ys = y.reshape(y.shape[:-1] + (T, m // T)).movedim(-2, 0)
    if w_cdc is None or code.n_parity == 0 or valid is None:
        return merge_shards(ys)
    parity = _shardwise_matmul(x, w_cdc)
    return decode_and_merge(ys, parity, spec, valid,
                            valid_parity=valid_parity, use_fused=fused_decode)


def decode_folded(ys: torch.Tensor, p_slots: torch.Tensor, valid,
                  code: CodeSpec, *, valid_parity=None) -> torch.Tensor:
    """Recover erased data shards under the folded/staggered placement.

    ys: [T, ..., m_l] (erased entries zeroed); p_slots: [T, ..., r*w]
    (erased zeroed); valid: [T], at most floor(r/2) False. Per slice s the
    equations are the surviving parities by lowest j first; the unknowns
    are the erased shards by lowest index first.
    """
    T, r = code.n_shards, code.n_parity
    f = max(r // 2, 1)
    m_l = ys.shape[-1]
    w = m_l // T
    dev = ys.device
    vh = host_mask(valid)
    vph = vh if valid_parity is None else host_mask(valid_parity)

    parity = unfold_parity(p_slots, T, r).to(torch.float32)   # [r, ..., m_l]
    gen = generator_tensor(code, dev)
    y = ys.to(torch.float32)
    residual = parity - torch.tensordot(gen, y, dims=([1], [0]))

    pv = vph[folded_slot_map(T, r)]                          # [r, S]
    miss_idx = erased_first(vh, f)                           # [f]
    is_real = ~vh[miss_idx]
    # per slice: surviving equations by lowest j, then dead ones by lowest j
    eq_idx = np.stack([np.concatenate([np.flatnonzero(pv[:, s]),
                                       np.flatnonzero(~pv[:, s])])[:f]
                       for s in range(T)])                   # [S, f]

    gen_h = code.generator.astype(np.float32)
    A = gen_h[eq_idx][..., miss_idx]                         # [S, f, f]
    A = np.where(is_real[None, None, :], A, np.eye(f, dtype=np.float32))
    A = torch.as_tensor(A, device=dev)

    mid = residual.shape[1:-1]
    res_sliced = residual.reshape((r,) + mid + (T, w)).movedim(-2, 1)
    eq = torch.as_tensor(eq_idx.T, device=dev)               # [f, S]
    rhs = torch.stack([res_sliced[eq[e], torch.arange(T, device=dev)]
                       for e in range(f)])                   # [f, S, ..., w]
    real = torch.as_tensor(is_real, device=dev)
    zero = torch.zeros((), device=dev)
    rhs = torch.where(real.reshape((f,) + (1,) * (rhs.ndim - 1)), rhs, zero)

    K = int(np.prod(rhs.shape[2:]))
    rhs_flat = rhs.movedim(0, 1).reshape(T, f, K)
    sol = torch.linalg.solve(A, rhs_flat)                    # [S, f, K]
    sol = sol.reshape((T, f) + tuple(rhs.shape[2:])).movedim(1, 0)

    upd = torch.where(real.reshape((f,) + (1,) * (sol.ndim - 1)), sol, zero)
    y_sliced = y.reshape(y.shape[:-1] + (T, w)).movedim(-2, 1)
    y_sliced = y_sliced.index_add(
        0, torch.as_tensor(miss_idx, device=dev), upd)
    y_out = y_sliced.movedim(1, -2).reshape(y.shape)
    return y_out.to(ys.dtype)
