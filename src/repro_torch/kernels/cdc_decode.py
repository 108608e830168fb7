"""Fused coded LM head + Eq. 12 parity decode + greedy argmax.

``cdc_fused_head_argmax`` takes the last-position hidden states x [b, k],
the T head shards [T, k, m_l] (a strided view of ``lm_head.w``, read in
place) and the sum-parity head weight [k, m_l], and returns the greedy
token and its logit per row without materialising the [b, vocab] logits.
On a CUDA tensor it launches the kernel in ``csrc/cdc_fused_head.cu``; on
a CPU tensor it runs the plain version ``ref.fused_head_argmax_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.coding import host_mask
from repro_torch.kernels import build, ref
from repro_torch.kernels.cdc_matmul import (_BN, _RB, _tile_counters,
                                            mask_bits)


def _lib():
    fn = build.load("cdc_fused_head").cdc_fused_head_argmax_f32
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, ll, ll, i,
                       ctypes.c_uint, p]
        fn.restype = i
    return fn


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"cdc_fused_head_argmax: {msg}")


def cdc_fused_head_argmax(x: torch.Tensor, w_shards: torch.Tensor,
                          parity_w: torch.Tensor, valid, *, vocab: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [b, k] f32; w_shards [T, k, m_l] (unit column stride); parity_w
    [k, m_l]; valid [T] host mask with at most one False. Returns
    (token int32 [b], max logit f32 [b]); ties go to the smallest id."""
    if x.device.type == "cpu":
        return ref.fused_head_argmax_ref(
            x, w_shards, parity_w, torch.as_tensor(host_mask(valid)), vocab)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    b, k = x.shape
    T, k2, m_l = w_shards.shape
    _check(all(t.dtype == torch.float32 for t in (x, w_shards, parity_w)),
           "x, w_shards and parity_w must be float32")
    _check(w_shards.device == x.device and parity_w.device == x.device,
           "all tensors must be on one device")
    _check(x.is_contiguous() and k2 == k and w_shards.stride(2) == 1,
           f"x {tuple(x.shape)} / w_shards {tuple(w_shards.shape)} layout")
    _check(parity_w.is_contiguous() and tuple(parity_w.shape) == (k, m_l),
           f"parity_w {tuple(parity_w.shape)} != {(k, m_l)}")
    n_tiles = -(-m_l // _BN)
    tok = torch.empty(b, dtype=torch.int32, device=x.device)
    vmax = torch.empty(b, dtype=torch.float32, device=x.device)
    part_val = torch.empty((n_tiles, b), dtype=torch.float32,
                           device=x.device)
    part_idx = torch.empty((n_tiles, b), dtype=torch.int32, device=x.device)
    sem = _tile_counters(x.device, -(-b // _RB))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()(x.data_ptr(), w_shards.data_ptr(), parity_w.data_ptr(),
                 part_val.data_ptr(), part_idx.data_ptr(), sem.data_ptr(),
                 tok.data_ptr(), vmax.data_ptr(), b, k, T, m_l,
                 w_shards.stride(0), w_shards.stride(1), vocab,
                 mask_bits(valid), stream)
    if err != 0:
        raise RuntimeError(f"cdc_fused_head_argmax kernel launch failed: "
                           f"cudaError {err}")
    cdc_fused_head_argmax.launches += 1
    return tok, vmax


cdc_fused_head_argmax.launches = 0
