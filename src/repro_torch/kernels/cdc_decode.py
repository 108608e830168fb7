"""The r=1 Eq. 12 decode, and the fused coded LM head + decode + argmax.

``cdc_decode`` takes stacked shard outputs y [T, m, n], their sum parity
[m, n] and a [T] host mask with at most one False, and returns all T
shards with the dead one rebuilt (dead shards zeroed by multiply, as the
reference writes it). On a CUDA tensor it launches the kernel in
``csrc/cdc_decode.cu``; on a CPU tensor it runs ``ref.cdc_decode_ref``.

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
from repro_torch.kernels.cdc_matmul import _tile_counters, mask_bits

_BN, _RB = 32, 8     # kernel 2's column tile and row tile (coded_tile.cuh)


def _decode_lib():
    fn = build.load("cdc_decode").cdc_decode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, ctypes.c_longlong, ctypes.c_uint, i, p]
        fn.restype = i
    return fn


def cdc_decode(y_shards: torch.Tensor, parity: torch.Tensor, valid
               ) -> torch.Tensor:
    """y [T, m, n] (any trailing shape), parity [m, n] of y's dtype, valid
    [T] host mask with at most one False -> [T, m, n] in y's dtype."""
    vh = host_mask(valid)
    if y_shards.device.type == "cpu":
        return ref.cdc_decode_ref(y_shards, parity, torch.as_tensor(vh))
    who = "cdc_decode"
    if y_shards.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {y_shards.device}")
    bf16 = build.bf16_flag(y_shards.dtype, who)
    T = y_shards.shape[0]
    if not (parity.dtype == y_shards.dtype
            and parity.device == y_shards.device
            and tuple(parity.shape) == tuple(y_shards.shape[1:])
            and y_shards.is_contiguous() and parity.is_contiguous()
            and vh.shape == (T,)):
        raise ValueError(f"{who}: y {tuple(y_shards.shape)} / parity "
                         f"{tuple(parity.shape)} / valid {vh.shape}: want "
                         f"contiguous [T, ...] and [...] of one dtype, [T]")
    out = torch.empty_like(y_shards)
    n = parity.numel()
    if n == 0:
        return out
    stream = torch.cuda.current_stream(y_shards.device).cuda_stream
    err = _decode_lib()(y_shards.data_ptr(), parity.data_ptr(),
                        out.data_ptr(), T, n, mask_bits(vh), bf16, stream)
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed: cudaError {err}")
    cdc_decode.launches += 1
    return out


cdc_decode.launches = 0


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
