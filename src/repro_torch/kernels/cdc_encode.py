"""Offline CDC parity encode (paper Eq. 7/11): parity[j] = Σ_i gen[j,i]·W_i.

``cdc_encode`` takes the T column shards of a weight as a strided view
[T, k, m_l] (or a stacked [L, T, k, m_l]), usually a view of the raw
[k, T·m_l] weight with no copy, and a host generator [r, T]; it returns
the parity in the layout the coded layers hold: dedicated [r, k, m_l] or
folded slots [T, k, r·m_l/T] (with the leading [L] when stacked). On a
CUDA tensor it launches the kernel in ``csrc/cdc_encode.cu`` (one launch
per call, stacked layers included) or raises; on a CPU tensor it runs the
plain version, ``ref.cdc_encode_ref`` per layer followed by
``fold_parity_slots``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.coded_layer import fold_parity_slots
from repro_torch.kernels import accounting, build, ref

# the (T, r) cases the kernel is built for: r <= T at T in {2, 4, 8}, and
# r <= 4 at T = 16 (the coded-overhead study's T = 16 and the planner's r)
_MAX_R = {2: 2, 4: 4, 8: 8, 16: 4}


def _lib():
    fn = build.load("cdc_encode").cdc_encode
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, i, i, i, i, i, ll, ll, ll, i, i, i, p]
        fn.restype = i
    return fn


def check_code(T: int, r: int) -> None:
    """Refuse a code the encode kernel has no case for (before any
    build)."""
    build.check_t("cdc_encode", T, tuple(_MAX_R))
    if not 0 <= r <= _MAX_R[T]:
        raise ValueError(f"cdc_encode: no kernel case for T={T}, r={r}; r "
                         f"runs 1..{_MAX_R[T]} at T={T}")


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"cdc_encode: {msg}")


def host_generator(gen) -> np.ndarray:
    """The host generator as a float32 [r, T] array (the cast the parity
    math uses)."""
    return np.ascontiguousarray(np.asarray(gen, np.float32))


def encode_plain(w_shards: torch.Tensor, gen, layout: str) -> torch.Tensor:
    """The plain version behind ``cdc_encode``, with the same arguments:
    one layer at a time, so the temporaries stay one layer big."""
    g = torch.as_tensor(host_generator(gen), device=w_shards.device)
    if w_shards.ndim == 4:
        first = encode_plain(w_shards[0], gen, layout)
        out = first.new_empty((w_shards.shape[0],) + tuple(first.shape))
        out[0] = first
        for i in range(1, w_shards.shape[0]):
            out[i] = encode_plain(w_shards[i], gen, layout)
        return out
    parity = ref.cdc_encode_ref(w_shards, g)              # [r, k, m_l]
    if layout == "dedicated":
        return parity
    return fold_parity_slots(parity, w_shards.shape[0])


@accounting.costed("cdc_encode")
def cdc_encode(w_shards: torch.Tensor, gen, *, layout: str = "dedicated"
               ) -> torch.Tensor:
    """Parity weights of the shards [T, k, m_l] or [L, T, k, m_l] (unit
    column stride; any shard, row and layer strides; float32 or bf16)
    under the host generator ``gen`` [r, T]: dedicated [(L,) r, k, m_l] or
    folded [(L,) T, k, r·m_l/T], in the shards' dtype (float32 math)."""
    _check(layout in ("folded", "dedicated"), f"unknown layout {layout!r}")
    if w_shards.device.type == "cpu":
        return encode_plain(w_shards, gen, layout)
    _check(w_shards.device.type == "cuda",
           f"unsupported device {w_shards.device}")
    bf16 = build.bf16_flag(w_shards.dtype, "cdc_encode")
    _check(w_shards.ndim in (3, 4), "w_shards must be [T, k, m_l] or "
           "[L, T, k, m_l]")
    g = host_generator(gen)
    stacked = w_shards.ndim == 4
    L = w_shards.shape[0] if stacked else 1
    T, k, m_l = w_shards.shape[-3:]
    r = g.shape[0]
    _check(g.ndim == 2 and g.shape[1] == T, f"gen {g.shape} is not [r, {T}]")
    check_code(T, r)
    _check(w_shards.stride(-1) == 1, "shards need a unit column stride")
    folded = layout == "folded"
    _check(not folded or m_l % T == 0,
           f"shard width {m_l} not divisible by T={T}")
    lead = (L,) if stacked else ()
    shape = (T, k, r * m_l // T) if folded else (r, k, m_l)
    out = torch.empty(lead + shape, dtype=w_shards.dtype,
                      device=w_shards.device)
    if r == 0 or out.numel() == 0:
        return out
    ld_t, ld_k = w_shards.stride(-3), w_shards.stride(-2)
    ld_l = w_shards.stride(0) if stacked else 0
    # 16-byte vectors (4 float32 or 8 bf16 columns) where every row, shard
    # and layer offset, and every folded slice, is whole vectors
    e = build.elem_bytes(w_shards.dtype)
    vec = 16 // e
    aligned = (w_shards.data_ptr() % 16 == 0
               and all(n * e % 16 == 0 for n in (m_l, ld_t, ld_k, ld_l))
               and (not folded or (m_l // T) * e % 16 == 0))
    gen_host = (ctypes.c_float * g.size)(*g.ravel().tolist())
    stream = torch.cuda.current_stream(w_shards.device).cuda_stream
    err = _lib()(w_shards.data_ptr(), out.data_ptr(), gen_host, L, k, T, r,
                 m_l, ld_t, ld_k, ld_l, int(folded), vec if aligned else 1,
                 bf16, stream)
    if err != 0:
        raise RuntimeError(f"cdc_encode kernel launch failed: cudaError "
                           f"{err}")
    cdc_encode.launches += 1
    return out


cdc_encode.launches = 0
