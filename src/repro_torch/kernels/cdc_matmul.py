"""Fused coded matmul + Eq. 12 decode + merge, and the decode + merge alone.

``cdc_coded_matmul`` runs, for x [rows, k], the T shard GEMMs of w [k, m]
and the r parity GEMMs, rebuilds at most one dead shard from its
per-column parity equation, and writes the merged [rows, T, m_l] output
(its reshape to [rows, m] is free). On a CUDA tensor it launches the
kernel in ``csrc/coded_matmul.cuh`` (the library ``coded_lib`` names for
the code width and the weights' storage type); on a CPU tensor it runs the
plain version ``ref.cdc_coded_matmul_ref``. The decode plan comes from
``eq12_plan``, a small tensor function.

``cdc_decode_merge`` is the same decode and merge on shard outputs that
were already computed (``core.decode_and_merge(use_fused=True)``): the
kernel in ``csrc/cdc_decode_merge.cu`` on a CUDA tensor, the plain
version ``ref.cdc_decode_merge_ref`` on a CPU tensor.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.core.coded_layer import folded_slot_map, unfold_parity
from repro_torch.core.coding import generator_tensor, host_mask
from repro_torch.kernels import accounting, build, ref, stream_plan

_sem: dict[int, torch.Tensor] = {}   # per-device tile counters (see below)
_sem_retired: list[torch.Tensor] = []  # outgrown counters, kept alive
_sms: dict[int, int] = {}            # SMs per device
# kernel 1's tuned instantiations: the largest r of each code width T
# (csrc/cdc_coded_matmul.cu, _bf16.cu, _t16.cu); every other code with
# 2 <= T <= 16, 1 <= r <= T takes the generic instantiation
TUNED_MAX_R = {2: 2, 4: 4, 8: 4, 16: 4}


def streams_per_warp(streams: int) -> int:
    """Streams a consumer warp of the generic instantiation owns
    (``streams_per_warp`` in csrc/coded_matmul.cuh)."""
    return 1 if streams <= 16 else 2 if streams <= 24 else 3


def check_code(T: int, r: int) -> None:
    """Refuse a code kernel 1 has no case for (before any build)."""
    build.check_r("cdc_coded_matmul", T, r)


def check_merge(T: int) -> None:
    """Refuse a code width kernel 3 has no case for (before any build)."""
    build.check_t("cdc_decode_merge", T)


def coded_lib(T: int, r: int, bf16: bool) -> str:
    """The library holding kernel 1's instantiation for the code (T, r)
    and the weights' storage type (csrc/cdc_coded_matmul*.cu)."""
    if r > TUNED_MAX_R.get(T, 0):
        return "cdc_coded_matmul_any_bf16" if bf16 else \
            "cdc_coded_matmul_any"
    if T == 16:
        return "cdc_coded_matmul_t16"
    return "cdc_coded_matmul_bf16" if bf16 else "cdc_coded_matmul"


def eq12_plan(spec, valid: torch.Tensor, valid_parity: torch.Tensor,
              m_l: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-column decode plan for the <= 1-erasure regime.

    Returns (esel [m_l] int32, coef [m_l] f32): column c of the dead shard
    d (the lowest-index dead shard, 0 when none is dead) is rebuilt as
    coef[c] * (p_esel[c] - sum_i gen[esel[c], i] * y_i), coef =
    1/gen[esel[c], d]. The folded layout picks, per slice, the lowest
    parity j whose staggered slice survived (0 when none did); every other
    case uses the sum row.
    """
    code = spec.code
    T, r = code.n_shards, code.n_parity
    valid = torch.as_tensor(valid, dtype=torch.bool)
    valid_parity = torch.as_tensor(valid_parity, dtype=torch.bool,
                                   device=valid.device)
    dev = valid.device
    gen = generator_tensor(code, dev)
    idx = torch.arange(T, device=dev)
    d = torch.where(valid, T, idx).min() % T   # first dead shard, else 0
    if spec.layout == "folded" and r > 1 and m_l % T == 0:
        smap = torch.as_tensor(folded_slot_map(T, r), device=dev)
        alive = valid_parity[smap]                              # [r, T]
        js = torch.arange(r, device=dev)[:, None]
        lowest = torch.where(alive, js, r).min(0).values % r    # [T]
        esel = lowest.repeat_interleave(m_l // T).to(torch.int32)
    else:
        esel = torch.zeros(m_l, dtype=torch.int32, device=dev)
    coef = (1.0 / gen[esel.long(), d]).to(torch.float32)
    return esel, coef


def coded_variant(rows: int, m_l: int, T: int, r: int, layout: str,
                  ldw: int | None = None, ptr_aligned: bool = True,
                  elem: int = 4) -> tuple[int, bool]:
    """(rows a block, bulk copies?) of the kernel instantiation a call
    takes. The copy engine needs w's and the parity's row strides in whole
    16-byte units, the slice width and m_l in whole 8-byte units (a box
    may start half a vector before its tile: ``coded_lead``), and 16-byte
    aligned bases (``ptr_aligned``)."""
    folded = layout == "folded"
    wd = m_l // T if folded else m_l
    ldw = T * m_l if ldw is None else ldw
    pstride = r * wd if folded else m_l
    aligned = (ptr_aligned
               and all(n * elem % 16 == 0 for n in (ldw, pstride))
               and all(n * elem % 8 == 0 for n in (m_l, wd)))
    return stream_plan.row_block(rows, wd, T if folded else 1, T + r), \
        aligned


def coded_lead(m_l: int, T: int, layout: str, aligned: bool,
               elem: int = 4) -> int:
    """Elements by which a box row on the copy engine is wider than its
    tile: a copy starts on a 16-byte boundary, so where the slice width
    or m_l is no whole number of 16-byte vectors (granite's 50-column
    slices at T = 16) each box starts at the boundary before its tile."""
    v = 16 // elem
    wd = m_l // T if layout == "folded" else m_l
    return v if aligned and (m_l % v or wd % v) else 0


@functools.lru_cache(maxsize=1024)
def coded_plan(rows: int, k: int, m_l: int, T: int, r: int, layout: str,
               n_sm: int, occupancy: int, ldw: int | None = None,
               ptr_aligned: bool = True, elem: int = 4
               ) -> stream_plan.StreamPlan:
    """The launch plan of one ``cdc_coded_matmul`` call: T + r weight
    streams, column tiles cut inside each folded parity slice (or across
    m_l for the dedicated layout), RB = 4 for rows <= 4, and k split so
    that the blocks fill whole waves of ``n_sm * occupancy`` resident
    blocks (the occupancy of the instantiation ``coded_variant`` names,
    as the C interface reports it)."""
    folded = layout == "folded"
    _, aligned = coded_variant(rows, m_l, T, r, layout, ldw, ptr_aligned,
                               elem)
    return stream_plan.plan(rows, k, m_l // T if folded else m_l,
                            T if folded else 1, T + r, n_sm * occupancy,
                            aligned, elem,
                            coded_lead(m_l, T, layout, aligned, elem))


def _n_sm(device: torch.device) -> int:
    n = _sms.get(device.index)
    if n is None:
        n = _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _tile_counters(device: torch.device, n: int) -> torch.Tensor:
    """Zeroed per-tile arrival counters. Each launch leaves them at zero
    again, so one buffer per device serves every launch on its stream. An
    outgrown buffer is never freed: a captured CUDA graph may still hold
    its address."""
    sem = _sem.get(device.index)
    if sem is None or sem.numel() < n:
        if sem is not None:
            _sem_retired.append(sem)
        sem = _sem[device.index] = torch.zeros(max(n, 4096),
                                               dtype=torch.int32,
                                               device=device)
    return sem


def _lib(name: str):
    fn = build.load(name).cdc_coded_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, i, p, p, p, p, ctypes.c_float, p, p, p,
                       i, i, i, i, i, ctypes.c_longlong, i, ctypes.c_uint,
                       i, i, i, i, i, i, i, i, i, p]
        fn.restype = i
    return fn


def mask_bits(valid) -> int:
    return sum(1 << t for t, ok in enumerate(host_mask(valid)) if ok)


def coded_matmul_plain(x, w, w_cdc, layout, T, r, gen, esel, coef, valid,
                       gamma=None, eps=1e-5):
    """The plain version behind ``cdc_coded_matmul``, taking the same
    arguments (weights in their stored layouts)."""
    k, m = w.shape
    w_st = w.reshape(k, T, m // T).permute(1, 0, 2)           # view
    pw = w_cdc if layout == "dedicated" else unfold_parity(w_cdc, T, r)
    return ref.cdc_coded_matmul_ref(
        x, w_st, pw, gen, esel, coef,
        torch.as_tensor(host_mask(valid)), gamma=gamma, eps=eps)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"cdc_coded_matmul: {msg}")


@accounting.costed("cdc_coded_matmul")
def cdc_coded_matmul(x: torch.Tensor, w: torch.Tensor, w_cdc: torch.Tensor,
                     layout: str, T: int, r: int, gen: torch.Tensor,
                     esel: torch.Tensor, coef: torch.Tensor, valid, *,
                     gamma: torch.Tensor | None = None, eps: float = 1e-5
                     ) -> torch.Tensor:
    """(rmsnorm?) + coded shard GEMMs + Eq. 12 decode + merge.

    x [rows, k] float32 or bf16; w [k, T*m_l] (rows of w may be strided)
    and w_cdc (folded [T, k, r*m_l/T] or dedicated [r, k, m_l]) of one
    storage type, float32 or bf16; gen [r, T], coef and gamma float32;
    esel/coef from ``eq12_plan``; valid [T] host mask with at most one
    False. Returns merged [rows, T, m_l] in x's dtype (float32 math).
    """
    if x.device.type in build.PLAIN_DEVICES:
        return coded_matmul_plain(x, w, w_cdc, layout, T, r, gen, esel,
                                  coef, valid, gamma, eps)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    build.refuse_grad("cdc_coded_matmul", x, w, w_cdc, gamma)
    check_code(T, r)
    rows, k = x.shape
    m_l = w.shape[1] // T
    folded = layout == "folded"
    f32 = [gen, coef] + ([gamma] if gamma is not None else [])
    tensors = [x, w, w_cdc] + f32
    x_bf16 = build.bf16_flag(x.dtype, "cdc_coded_matmul: x")
    w_bf16 = build.bf16_flag(w.dtype, "cdc_coded_matmul: w")
    _check(w_cdc.dtype == w.dtype, "w and its parity must share a dtype")
    _check(all(t.dtype == torch.float32 for t in f32),
           "gen, coef and gamma must be float32")
    _check(esel.dtype == torch.int32, "esel must be int32")
    _check(all(t.device == x.device for t in tensors + [esel]),
           "all tensors must be on one device")
    _check(x.is_contiguous() and w.ndim == 2 and w.shape[0] == k
           and w.stride(1) == 1 and w.shape[1] == T * m_l,
           f"x {tuple(x.shape)} / w {tuple(w.shape)} layout")
    pshape = (T, k, r * (m_l // T)) if folded else (r, k, m_l)
    _check(w_cdc.is_contiguous() and tuple(w_cdc.shape) == pshape
           and (not folded or m_l % T == 0),
           f"parity {tuple(w_cdc.shape)} != {pshape}")
    _check(gen.is_contiguous() and tuple(gen.shape) == (r, T),
           "gen must be [r, T]")
    _check(tuple(esel.shape) == (m_l,) and tuple(coef.shape) == (m_l,)
           and esel.is_contiguous() and coef.is_contiguous(),
           "esel/coef must be [m_l]")
    _check(gamma is None or (gamma.is_contiguous()
                             and tuple(gamma.shape) == (k,)),
           "gamma must be [k]")
    ldw = w.stride(0)
    ptr_ok = (w.data_ptr() | w_cdc.data_ptr()) % 16 == 0
    elem = build.elem_bytes(w.dtype)
    lib = coded_lib(T, r, bool(w_bf16))
    rb, aligned = coded_variant(rows, m_l, T, r, layout, ldw, ptr_ok, elem)
    plan = coded_plan(rows, k, m_l, T, r, layout, _n_sm(x.device),
                      build.occupancy(lib, "cdc_coded_matmul_occupancy", T,
                                      r, w_bf16, rb, int(aligned)),
                      ldw, ptr_ok, elem)
    out = torch.empty((rows, T, m_l), dtype=x.dtype, device=x.device)
    ws = torch.empty((plan.ksplit if plan.ksplit > 1 else 0, rows, T * m_l),
                     dtype=torch.float32, device=x.device)
    sem = _tile_counters(x.device, plan.counters)
    stream = build.raw_stream(x.device)
    err = _lib(lib)(x.data_ptr(), x_bf16, w.data_ptr(), w_cdc.data_ptr(),
                 w_bf16, gen.data_ptr(), esel.data_ptr(), coef.data_ptr(),
                 gamma.data_ptr() if gamma is not None else None, eps,
                 out.data_ptr(), ws.data_ptr(), sem.data_ptr(), rows, k, T,
                 r, m_l, ldw, int(folded), mask_bits(valid), plan.rb,
                 int(plan.aligned), plan.bn, plan.tps, plan.wd, plan.nrb,
                 plan.ksplit, plan.kchunk, plan.ks, stream)
    if err != 0:
        raise RuntimeError(f"cdc_coded_matmul kernel launch failed: "
                           f"cudaError {err} (plan {plan})")
    cdc_coded_matmul.launches += 1
    spw = streams_per_warp(T + r)
    generic = "" if "_any" not in lib else \
        "-any" + (str(spw) if spw > 1 else "")
    cdc_coded_matmul.variants[plan.variant + generic] += 1
    return out


cdc_coded_matmul.launches = 0
cdc_coded_matmul.variants = collections.Counter()   # launches per variant


# ------------------------------------------------------- decode + merge --

def _dm_lib():
    fn = build.load("cdc_decode_merge").cdc_decode_merge
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.c_uint, i, i,
                       p]
        fn.restype = i
    return fn


def decode_merge_plain(ys, parity, layout, T, r, gen, esel, coef, valid):
    """The plain version behind ``cdc_decode_merge``, taking the same
    arguments (parity in its stored layout)."""
    par = parity if layout == "dedicated" else unfold_parity(parity, T, r)
    return ref.cdc_decode_merge_ref(ys, par, gen, esel, coef,
                                    torch.as_tensor(host_mask(valid)))


@accounting.costed("cdc_decode_merge")
def cdc_decode_merge(ys: torch.Tensor, parity: torch.Tensor, layout: str,
                     T: int, r: int, gen: torch.Tensor, esel: torch.Tensor,
                     coef: torch.Tensor, valid) -> torch.Tensor:
    """Eq. 12 decode + merge of shard outputs ys [T, rows, m_l] with the
    parity outputs in their stored layout (dedicated [r, rows, m_l] or
    folded [T, rows, r*m_l/T], read in place); gen [r, T]; esel/coef from
    ``eq12_plan``; valid [T] host mask with at most one False. Returns
    merged [rows, T, m_l] in ys' dtype."""
    if ys.device.type in build.PLAIN_DEVICES:
        return decode_merge_plain(ys, parity, layout, T, r, gen, esel, coef,
                                  valid)
    who = "cdc_decode_merge"
    if ys.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {ys.device}")
    build.refuse_grad(who, ys, parity)
    check_merge(T)
    folded = layout == "folded"
    _, rows, m_l = ys.shape
    bf16 = build.bf16_flag(ys.dtype, who)
    pshape = (T, rows, r * (m_l // T)) if folded else (r, rows, m_l)
    if not (ys.shape[0] == T and parity.dtype == ys.dtype
            and ys.is_contiguous() and parity.is_contiguous()
            and tuple(parity.shape) == pshape
            and (not folded or m_l % T == 0)):
        raise ValueError(f"{who}: ys {tuple(ys.shape)} {ys.dtype} / parity "
                         f"{tuple(parity.shape)} {parity.dtype}; want "
                         f"contiguous [{T}, rows, m_l] and {pshape} of one "
                         f"dtype")
    if not (gen.dtype == torch.float32 and tuple(gen.shape) == (r, T)
            and esel.dtype == torch.int32 and coef.dtype == torch.float32
            and tuple(esel.shape) == (m_l,) and tuple(coef.shape) == (m_l,)
            and all(t.is_contiguous() and t.device == ys.device
                    for t in (gen, esel, coef, parity))):
        raise ValueError(f"{who}: gen [r, T] f32, esel [m_l] int32 and coef "
                         f"[m_l] f32 must be contiguous on {ys.device}")
    out = torch.empty((rows, T, m_l), dtype=ys.dtype, device=ys.device)
    if out.numel() == 0:
        return out
    # 16-byte groups of columns where every row and slice is whole groups
    v = 16 // build.elem_bytes(ys.dtype)
    vec = v if (m_l % v == 0 and (not folded or (m_l // T) % v == 0)
                and (ys.data_ptr() | parity.data_ptr() | out.data_ptr())
                % 16 == 0) else 1
    err = _dm_lib()(ys.data_ptr(), parity.data_ptr(), gen.data_ptr(),
                    esel.data_ptr(), coef.data_ptr(), out.data_ptr(), rows,
                    m_l, T, r, int(folded), mask_bits(valid), bf16, vec,
                    build.raw_stream(ys.device))
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed: cudaError {err}")
    cdc_decode_merge.launches += 1
    cdc_decode_merge.variants["vec" if vec > 1 else "scalar"] += 1
    return out


cdc_decode_merge.launches = 0
cdc_decode_merge.variants = collections.Counter()   # launches per variant
