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
On a CUDA tensor it launches the kernel in ``csrc/fused_head.cuh`` (the
library ``head_lib`` names for the weights' storage type) with the launch
plan ``head_plan`` (the weight-streaming plan of ``stream_plan``, T + 1
streams); on a CPU tensor it runs the plain version
``ref.fused_head_argmax_ref``.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.core.coding import host_mask
from repro_torch.kernels import accounting, build, ref, stream_plan
from repro_torch.kernels.cdc_matmul import _n_sm, _tile_counters, mask_bits


def check_decode(T: int) -> None:
    """Refuse a code width kernel 5 has no case for (before any build)."""
    build.check_t("cdc_decode", T)


def check_head(T: int) -> None:
    """Refuse a code width kernel 2 has no case for (before any build)."""
    build.check_t("cdc_fused_head_argmax", T)


def _decode_lib():
    fn = build.load("cdc_decode").cdc_decode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, ctypes.c_longlong, ctypes.c_uint, i, i, p]
        fn.restype = i
    return fn


@accounting.costed("cdc_decode")
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
    check_decode(T)
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
    # 16-byte vectors where the plane is whole vectors
    v = 16 // build.elem_bytes(y_shards.dtype)
    vec = v if (n % v == 0 and (y_shards.data_ptr() | parity.data_ptr()
                                | out.data_ptr()) % 16 == 0) else 1
    err = _decode_lib()(y_shards.data_ptr(), parity.data_ptr(),
                        out.data_ptr(), T, n, mask_bits(vh), bf16, vec,
                        build.raw_stream(y_shards.device))
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed: cudaError {err}")
    cdc_decode.launches += 1
    cdc_decode.variants["vec" if vec > 1 else "scalar"] += 1
    return out


cdc_decode.launches = 0
cdc_decode.variants = collections.Counter()   # launches per variant


def head_variant(b: int, m_l: int, ldw: int, shard_stride: int,
                 ptr_aligned: bool = True, T: int = 1, elem: int = 4,
                 ldp: int | None = None) -> tuple[int, bool]:
    """(rows a block, bulk copies?) of the kernel instantiation a call
    takes. The copy engine needs the shards' and the parity's row strides
    ``ldw`` and ``ldp`` (m_l by default) in whole 16-byte units, m_l in
    whole float32 vectors (the split sums' 16-byte reads), 16-byte aligned
    bases (``ptr_aligned``), and the shards' offset ``shard_stride``: in
    whole float32 vectors for column shards of one matrix (``shard_stride
    <= ldw``: one 2-D map, box rows widened by ``head_lead``), in whole
    16-byte units, as m_l, for shards stored one after another (a 3-D
    map)."""
    v = 16 // elem
    ldp = m_l if ldp is None else ldp
    aligned = (ptr_aligned and m_l % 4 == 0 and ldw % v == 0
               and ldp % v == 0
               and (shard_stride % 4 == 0 if shard_stride <= ldw
                    else m_l % v == 0 and shard_stride % v == 0))
    return stream_plan.row_block(b, m_l, 1, T + 1), aligned


def head_parity(w_shards: torch.Tensor) -> torch.Tensor:
    """The sum-parity head weight [k, m_l] of the shards [T, k, m_l], in
    rows that are whole 16-byte vectors (a view of padded rows where m_l
    is not: a bf16 head of m_l = 12292), so that the copy engine can read
    it."""
    _, k, m_l = w_shards.shape
    v = 16 // w_shards.element_size()
    buf = w_shards.new_empty((k, -(-m_l // v) * v))[:, :m_l]
    return torch.sum(w_shards, 0, out=buf) if buf.is_contiguous() else \
        buf.copy_(w_shards.sum(0))


def head_lead(ldw: int, shard_stride: int, aligned: bool, elem: int = 4
              ) -> int:
    """Elements by which a box row of the copy engine's 2-D map over
    column shards is wider than its tile: a copy starts on a 16-byte
    boundary, and shards whose offset is no whole number of 16-byte
    vectors (granite's bf16 head, 12292 columns at T = 4) start between
    two."""
    v = 16 // elem
    return v if aligned and shard_stride <= ldw and shard_stride % v else 0


@functools.lru_cache(maxsize=256)
def head_plan(b: int, k: int, m_l: int, T: int, n_sm: int, occupancy: int,
              aligned: bool = True, elem: int = 4, lead: int = 0
              ) -> stream_plan.StreamPlan:
    """The launch plan of one ``cdc_fused_head_argmax`` call: T + 1 weight
    streams (the head shards and the sum parity) of column tiles across
    m_l, and k split so that the blocks fill whole waves of ``n_sm *
    occupancy`` resident blocks (the occupancy of the instantiation
    ``head_variant`` names, as the C interface reports it); box rows
    ``lead`` (``head_lead``) elements wider than the tile."""
    return stream_plan.plan(b, k, m_l, 1, T + 1, n_sm * occupancy, aligned,
                            elem, lead)


def head_lib(bf16: bool) -> str:
    """The library of kernel 2's instantiations for the weights' storage
    type (csrc/cdc_fused_head*.cu)."""
    return "cdc_fused_head_bf16" if bf16 else "cdc_fused_head"


def head_occupancy(T: int, rb: int, aligned: bool, bf16: bool = False
                   ) -> int:
    """Resident blocks per SM of kernel 2's instantiation (T, storage
    type, rb, async), as the card reports it."""
    return build.occupancy(head_lib(bf16), "cdc_fused_head_occupancy", T,
                           int(bf16), rb, int(aligned))


def _lib(name: str):
    fn = build.load(name).cdc_fused_head_argmax
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, p, p, i, p, p, p, p, p, p, i, i, i, i, ll, ll,
                       ll, i, ctypes.c_uint, i, i, i, i, i, i, i, i, p]
        fn.restype = i
    return fn


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"cdc_fused_head_argmax: {msg}")


@accounting.costed("cdc_fused_head_argmax")
def cdc_fused_head_argmax(x: torch.Tensor, w_shards: torch.Tensor,
                          parity_w: torch.Tensor, valid, *, vocab: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [b, k] float32 or bf16; w_shards [T, k, m_l] and parity_w [k, m_l]
    (unit column strides; ``head_parity`` makes a parity the copy engine
    can read) of one storage type, float32 or bf16; valid [T] host mask
    with at most one False. Returns (token int32 [b], max logit f32 [b]);
    ties go to the smallest id."""
    if x.device.type == "cpu":
        return ref.fused_head_argmax_ref(
            x, w_shards, parity_w, torch.as_tensor(host_mask(valid)), vocab)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    b, k = x.shape
    T, k2, m_l = w_shards.shape
    check_head(T)
    x_bf16 = build.bf16_flag(x.dtype, "cdc_fused_head_argmax: x")
    w_bf16 = build.bf16_flag(w_shards.dtype, "cdc_fused_head_argmax: w")
    _check(parity_w.dtype == w_shards.dtype,
           "w_shards and parity_w must share a dtype")
    _check(w_shards.device == x.device and parity_w.device == x.device,
           "all tensors must be on one device")
    _check(x.is_contiguous() and k2 == k and w_shards.stride(2) == 1,
           f"x {tuple(x.shape)} / w_shards {tuple(w_shards.shape)} layout")
    _check(tuple(parity_w.shape) == (k, m_l) and parity_w.stride(1) == 1
           and parity_w.stride(0) >= m_l,
           f"parity_w {tuple(parity_w.shape)} != {(k, m_l)} with unit "
           f"column stride")
    ldw, sstr = w_shards.stride(1), w_shards.stride(0)
    ldp = parity_w.stride(0)
    ptr_ok = (w_shards.data_ptr() | parity_w.data_ptr()) % 16 == 0
    elem = build.elem_bytes(w_shards.dtype)
    rb, aligned = head_variant(b, m_l, ldw, sstr, ptr_ok, T, elem, ldp)
    plan = head_plan(b, k, m_l, T, _n_sm(x.device),
                     head_occupancy(T, rb, aligned, bool(w_bf16)), aligned,
                     elem, head_lead(ldw, sstr, aligned, elem))
    dev = x.device
    tok = torch.empty(b, dtype=torch.int32, device=dev)
    vmax = torch.empty(b, dtype=torch.float32, device=dev)
    part_val = torch.empty((plan.tiles, b), dtype=torch.float32, device=dev)
    part_idx = torch.empty((plan.tiles, b), dtype=torch.int32, device=dev)
    ws = torch.empty(plan.ksplit * plan.counters * (T + 1) * plan.rb
                     * stream_plan.BN[plan.rb] if plan.ksplit > 1 else 0,
                     dtype=torch.float32, device=dev)
    sem = _tile_counters(dev, plan.counters + plan.nrb)
    err = _lib(head_lib(bool(w_bf16)))(
        x.data_ptr(), x_bf16, w_shards.data_ptr(), parity_w.data_ptr(),
        w_bf16, ws.data_ptr(), part_val.data_ptr(), part_idx.data_ptr(),
        sem.data_ptr(), tok.data_ptr(), vmax.data_ptr(), b, k, T, m_l, sstr,
        ldw, ldp, vocab, mask_bits(valid), plan.rb, int(plan.aligned), plan.bn,
        plan.tps, plan.nrb, plan.ksplit, plan.kchunk, plan.ks,
        build.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"cdc_fused_head_argmax kernel launch failed: "
                           f"cudaError {err} (plan {plan})")
    cdc_fused_head_argmax.launches += 1
    cdc_fused_head_argmax.variants[plan.variant] += 1
    return tok, vmax


cdc_fused_head_argmax.launches = 0
cdc_fused_head_argmax.variants = collections.Counter()  # launches per variant
