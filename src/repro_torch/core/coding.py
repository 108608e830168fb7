"""CDC erasure codes over output-split GEMM shards (paper §5.2-5.3, §7).

For T weight shards W_1..W_T split along the output dim, r parity shards
W_cdc[j] = sum_i gen[j, i] * W_i are computed offline. Row 0 of the
generator is all-ones: the paper's sum code, so one missing shard output is
recovered by a subtraction (Eq. 12). r > 1 uses Vandermonde rows on
positive nodes (every square minor nonsingular: an MDS code over the reals).

The generator is built in numpy float64 and cast to float32 for the
parity math, exactly as the reference does.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools

import numpy as np
import torch

__all__ = ["CodeSpec", "generator_matrix", "max_decode_condition",
           "encode_weights", "encode_outputs", "decode_outputs",
           "erased_first", "host_mask"]


@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """An (T + r, T) systematic erasure code over GEMM output shards."""

    n_shards: int
    n_parity: int = 1

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if not (0 <= self.n_parity <= self.n_shards):
            raise ValueError(
                f"n_parity must be in [0, n_shards], got {self.n_parity}")

    @property
    def total_shards(self) -> int:
        return self.n_shards + self.n_parity

    @functools.cached_property
    def generator(self) -> np.ndarray:
        return generator_matrix(self.n_shards, self.n_parity)


def generator_matrix(n_shards: int, n_parity: int) -> np.ndarray:
    """(r, T) float64 parity generator; row j holds x_i**j on geometrically
    spaced nodes in [1/2, 2], each row scaled to a maximum of 1."""
    if n_parity == 0:
        return np.zeros((0, n_shards), dtype=np.float64)
    i = np.arange(n_shards, dtype=np.float64)
    nodes = 2.0 ** (2.0 * i / max(n_shards - 1, 1) - 1.0) \
        if n_shards > 1 else np.ones(1)
    powers = np.arange(n_parity, dtype=np.float64)[:, None]
    gen = nodes[None, :] ** powers
    return gen / gen.max(axis=1, keepdims=True)


def max_decode_condition(spec: CodeSpec) -> float:
    """Worst condition number over the full-r erasure patterns: each r
    erased shards' columns of the generator, the system a decode solves.
    Checked offline, so an ill-conditioned (T, r) is rejected before
    deployment; exhaustive for small T, the first ~2000 patterns beyond."""
    if spec.n_parity == 0:
        return 1.0
    gen = spec.generator
    worst = 1.0
    combos = itertools.combinations(range(spec.n_shards), spec.n_parity)
    for n, missing in enumerate(combos):
        worst = max(worst, float(np.linalg.cond(gen[:, list(missing)])))
        if n > 2000:  # a sampled bound for very large T
            break
    return worst


def generator_tensor(spec: CodeSpec, device=None) -> torch.Tensor:
    """The generator cast to float32 (the cast the parity math uses)."""
    return torch.as_tensor(spec.generator.astype(np.float32), device=device)


def erased_first(valid: np.ndarray, n: int) -> np.ndarray:
    """The ``n`` shard indices a decode solves for: erased shards by lowest
    index first, then (as padding) healthy shards by lowest index first.

    The reference gets this order from a stable top-k over a +1/-1 erasure
    score; here it is spelled out so no sort's tie order matters."""
    valid = np.asarray(valid, bool)
    order = np.concatenate([np.flatnonzero(~valid), np.flatnonzero(valid)])
    return order[:n]


def host_mask(valid) -> np.ndarray:
    """A [T] bool mask (numpy, sequence or tensor) as a host numpy array."""
    if isinstance(valid, torch.Tensor):
        return valid.detach().cpu().numpy().astype(bool)
    return np.asarray(valid, bool)


def encode_weights(w_shards: torch.Tensor, spec: CodeSpec) -> torch.Tensor:
    """Offline parity weights (paper Eq. 7 / 11): [T, ..., m] -> [r, ..., m],
    W_cdc[j] = sum_i gen[j, i] * W_i, accumulated in float32."""
    if w_shards.shape[0] != spec.n_shards:
        raise ValueError(
            f"w_shards leading dim {w_shards.shape[0]} != T={spec.n_shards}")
    from repro_torch.kernels import ref
    return ref.cdc_encode_ref(w_shards, generator_tensor(spec,
                                                         w_shards.device))


def encode_outputs(y_shards: torch.Tensor, spec: CodeSpec) -> torch.Tensor:
    """Parity of shard outputs at run time, [T, ...] -> [r, ...] in their
    dtype: for oracles and tests only. A served round gets its parity
    outputs from the parity weights, never by gathering every shard's
    output (that is the point of the code)."""
    gen = torch.as_tensor(spec.generator, device=y_shards.device) \
        .to(y_shards.dtype)
    return torch.tensordot(gen, y_shards, dims=([1], [0]))


def decode_outputs(y_shards: torch.Tensor, parity: torch.Tensor, valid,
                   spec: CodeSpec) -> torch.Tensor:
    """Recover erased shard outputs: Eq. 12 for r=1, an r x r solve for r>1.

    y_shards: [T, ...] shard outputs (erased entries may hold garbage);
    parity: [r, ...]; valid: [T] host bool mask with at most r False.
    """
    T, r = spec.n_shards, spec.n_parity
    if r == 0:
        return y_shards
    dev = y_shards.device
    vh = host_mask(valid)
    vmask = torch.as_tensor(vh, device=dev).reshape((T,) + (1,) * (
        y_shards.ndim - 1))
    # select, not multiply: a NaN in an erased shard must not spread
    y = torch.where(vmask, y_shards.to(torch.float32),
                    torch.zeros((), device=dev))
    gen = generator_tensor(spec, dev)

    if r == 1:
        missing = parity[0].to(torch.float32) - y.sum(0)
        rec = torch.where(vmask, y, missing[None])
        return rec.to(y_shards.dtype)

    residual = parity.to(torch.float32) - torch.tensordot(
        gen, y, dims=([1], [0]))
    miss_idx = erased_first(vh, r)
    is_real = ~vh[miss_idx]
    A = gen[:, torch.as_tensor(miss_idx, device=dev)]
    eye = torch.eye(r, dtype=torch.float32, device=dev)
    real = torch.as_tensor(is_real, device=dev)
    A = torch.where(real[None, :], A, eye)
    rhs = torch.where(real.reshape((r,) + (1,) * (residual.ndim - 1)),
                      residual, torch.zeros((), device=dev))
    sol = torch.linalg.solve(A, rhs.reshape(r, -1)).reshape(rhs.shape)
    upd = torch.where(real.reshape((r,) + (1,) * (sol.ndim - 1)), sol,
                      torch.zeros((), device=dev))
    rec = y.index_add(0, torch.as_tensor(miss_idx, device=dev), upd)
    return rec.to(y_shards.dtype)
