"""Public wrappers of the port's kernels and their dispatch ladder.

The device policy replaces the reference's interpret switch: a CPU tensor
takes the kernel's plain version, a CUDA tensor launches the kernel or
raises. Masks are host-side, so the <= 1-erasure gate is always decided
here, before anything is launched:

  * ``fused_coded_matmul``: no parity, no mask, or 2+ dead shards -> the
    reference ``core.coded_matmul`` (full MDS recovery);
  * ``fused_head_argmax``: 2+ dead shards raise (the sum parity cannot
    solve for two unknowns); the caller takes the reference round;
  * ``fused_decode_merge``: no parity, no mask, or 2+ dead shards -> the
    reference ``core.decode_and_merge``;
  * ``cdc_decode``: 2+ dead shards raise (one sum parity, one unknown);
  * ``cdc_encode`` (re-exported from ``kernels.cdc_encode``): no ladder;
    the offline parity encode of every coded weight
    (``core.coded_layer.make_parity_weights``) goes through it;
  * ``rmsnorm`` and ``matmul`` (re-exported from ``kernels.rmsnorm`` and
    ``kernels.matmul``): no ladder (the serving round's norms, and the
    coded-overhead study's GEMM).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import coded_layer
from repro_torch.core.coding import generator_tensor, host_mask
from repro_torch.kernels import cdc_decode as _decode
from repro_torch.kernels import cdc_encode as _encode
from repro_torch.kernels import ref
from repro_torch.kernels.cdc_decode import cdc_fused_head_argmax
from repro_torch.kernels.cdc_encode import cdc_encode  # noqa: F401
from repro_torch.kernels.cdc_matmul import (cdc_coded_matmul,
                                            cdc_decode_merge, eq12_plan)
from repro_torch.kernels.matmul import matmul  # noqa: F401
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: F401


# ------------------------------------------------------- kernel cost model --
# Shape-based FLOP models of the ported kernels, keyed by wrapper name.
# Each takes (out_shapes, operand_shapes), lists of (dtype, dims) in the
# reference kernel's operand order, and returns dot-equivalent FLOPs.

def _elems(dims) -> int:
    n = 1
    for d in dims:
        n *= d
    return n


def _cost_matmul(out, operands):
    # x [m, k] @ w [k, n] -> [m, n]
    if not out or len(out[0][1]) != 2 or not operands:
        return 0.0
    m, n = out[0][1]
    k = operands[0][1][-1] if operands[0][1] else 0
    return 2.0 * m * n * k


def _zero_cost(out, operands):
    # elementwise / reduction kernels: no dot-equivalent FLOPs
    return 0.0


def _cost_cdc_encode(out, operands):
    # parity [r, ...] = gen [r, T] @ shards: 2 * out_elems * T
    t = next((d[1] for _, d in operands if len(d) == 2), 0)
    return 2.0 * sum(_elems(d) for _, d in out) * t


def _cost_cdc_coded_matmul(out, operands):
    # operand order: [valid, esel, coef, gen, x, w_shards, parity_w, gamma?]
    # out [rows, T, m_l]; T+r shard GEMMs of x [rows, k] @ [k, m_l]
    if not out or len(out[0][1]) != 3:
        return 0.0
    rows, t, m_l = out[0][1]
    rank3 = [d for _, d in operands if len(d) == 3]
    if len(rank3) < 2:
        return 0.0
    return 2.0 * rows * rank3[0][1] * m_l * (t + rank3[1][0])


def _cost_cdc_fused_head(out, operands):
    # operand order: [valid, x [b, k], w_shards [T, k, m_l], parity_w
    # [k, m_l]]; T shard GEMMs + 1 sum-parity GEMM of [b, k] @ [k, m_l]
    b = out[0][1][0] if out and out[0][1] else 0
    w = next((d for _, d in operands if len(d) == 3), None)
    if w is None:
        return 0.0
    t, k, m_l = w
    return 2.0 * b * k * m_l * (t + 1)


KERNEL_COSTS: dict = {
    "matmul": _cost_matmul,
    "cdc_encode": _cost_cdc_encode,
    "cdc_coded_matmul": _cost_cdc_coded_matmul,
    "cdc_fused_head_argmax": _cost_cdc_fused_head,
    "cdc_decode_merge": _zero_cost,
    "cdc_decode": _zero_cost,
    "rmsnorm": _zero_cost,
}


def _dims(t) -> tuple[str, list[int]]:
    return str(t.dtype).replace("torch.", ""), list(t.shape)


def _cost_operands(name: str, a: dict) -> list:
    """A wrapper's operands as (dtype, dims) in the reference kernel's
    operand order (what its ``KERNEL_COSTS`` model reads)."""
    if name == "cdc_coded_matmul":
        k, m = a["w"].shape
        T, r = a["T"], a["r"]
        wd = _dims(a["w"])[0]
        out = [("bool", [T]), _dims(a["esel"]), _dims(a["coef"]),
               _dims(a["gen"]), _dims(a["x"]), (wd, [T, k, m // T]),
               (wd, [r, k, m // T])]
        return out + ([_dims(a["gamma"])] if a["gamma"] is not None else [])
    if name == "cdc_fused_head_argmax":
        return [("bool", [a["w_shards"].shape[0]]), _dims(a["x"]),
                _dims(a["w_shards"]), _dims(a["parity_w"])]
    if name == "cdc_encode":
        gen = a["gen"]
        g = gen if isinstance(gen, torch.Tensor) \
            else _encode.host_generator(gen)
        return [("float32", list(g.shape)), _dims(a["w_shards"])]
    return [_dims(t) for k, t in a.items()
            if isinstance(t, torch.Tensor) and k != "valid"]


def kernel_cost(name: str, arguments: dict, result
                ) -> tuple[float, float] | None:
    """(FLOPs, bytes) of one wrapper call from its bound ``arguments`` and
    ``result``: the ``KERNEL_COSTS`` model's dot-equivalent FLOPs, and the
    bytes of every tensor operand (the host mask aside) and output, each
    counted once. None for a wrapper with no cost model."""
    model = KERNEL_COSTS.get(name)
    if model is None:
        return None
    outs = list(result) if isinstance(result, tuple) else [result]
    flops = float(model([_dims(t) for t in outs],
                        _cost_operands(name, arguments)))
    tensors = [t for k, t in arguments.items()
               if isinstance(t, torch.Tensor) and k != "valid"] + outs
    return flops, float(sum(t.numel() * t.element_size() for t in tensors))


def _dead(valid) -> int:
    if valid is None:
        return 0
    v = host_mask(valid)
    return int(v.size - v.sum())


@functools.lru_cache(maxsize=None)
def decode_plan(spec, valid: tuple, valid_parity: tuple, m_l: int,
                device: str):
    """Decode plan + generator on ``device``, computed once per mask and
    never evicted: a captured CUDA graph holds their addresses."""
    esel, coef = eq12_plan(spec, torch.tensor(valid),
                           torch.tensor(valid_parity), m_l)
    gen = generator_tensor(spec.code)
    return esel.to(device), coef.to(device), gen.to(device)


def cdc_decode(y_shards, parity, valid):
    """r=1 Eq. 12 recovery combine; <= 1 erased shard by construction. A
    mask with 2+ erasures raises (a single sum parity cannot solve for two
    unknowns); the r > 1 MDS layouts decode through ``core.coded_layer``
    or ``fused_decode_merge`` instead."""
    dead = _dead(valid)
    if dead > 1:
        raise ValueError(
            f"cdc_decode is the r=1 Eq. 12 combine (one parity equation) "
            f"and recovers at most 1 erased shard, got {dead} dead")
    return _decode.cdc_decode(y_shards, parity, valid)


def fused_head_argmax(x, w_shards, parity_w, valid, *, vocab):
    """Fused coded LM-head GEMM + Eq. 12 decode + greedy argmax for <= 1
    dead shard; 2+ dead raise (take the reference round instead)."""
    dead = _dead(valid)
    if dead > 1:
        raise ValueError(
            f"fused_head_argmax recovers at most 1 erased shard (Eq. 12 "
            f"sum-parity regime), got {dead} dead; use the reference "
            f"decode path (full logits + MDS recovery) for this round")
    return cdc_fused_head_argmax(x, w_shards, parity_w, valid, vocab=vocab)


def fused_coded_matmul(x, w, w_cdc, spec, valid, *, valid_parity=None,
                       gamma=None, eps=1e-5):
    """Fused in-body coded GEMM: (rmsnorm?) + T shard GEMMs + r parity
    GEMMs + Eq. 12 decode + merge. x: [..., k]; w: [k, m]; w_cdc in either
    layout (read in place). Returns the merged [..., m] activation."""
    code = spec.code
    T, r = code.n_shards, code.n_parity
    if w_cdc is None or r == 0 or valid is None or _dead(valid) > 1:
        xn = ref.rmsnorm_ref(x, gamma, eps) if gamma is not None else x
        return coded_layer.coded_matmul(xn, w, w_cdc, spec, valid,
                                        valid_parity=valid_parity)
    vh = tuple(bool(v) for v in host_mask(valid))
    vph = vh if valid_parity is None else \
        tuple(bool(v) for v in host_mask(valid_parity))
    k, m = w.shape
    esel, coef, gen = decode_plan(spec, vh, vph, m // T, str(x.device))
    lead = x.shape[:-1]
    out = cdc_coded_matmul(x.reshape(-1, k).contiguous(), w, w_cdc,
                           spec.layout, T, r, gen, esel, coef, vh,
                           gamma=gamma, eps=eps)
    return out.reshape(lead + (m,))


def fused_decode_merge(ys, parity, spec, valid, *, valid_parity=None):
    """Fused Eq. 12 decode + merge of already-computed shard outputs: the
    ``core.decode_and_merge`` tail as one kernel pass.

    ys: [T, ..., m_l]; parity: dedicated [r, ..., m_l] or folded slots
    [T, ..., r*w] (read in place). Same <= 1-erasure regime and fallback
    ladder as ``fused_coded_matmul``. Returns the merged [..., T*m_l] in
    ys' dtype."""
    code = spec.code
    T, r = code.n_shards, code.n_parity
    if parity is None or r == 0 or valid is None or _dead(valid) > 1:
        return coded_layer.decode_and_merge(ys, parity, spec, valid,
                                            valid_parity=valid_parity)
    vh = tuple(bool(v) for v in host_mask(valid))
    vph = vh if valid_parity is None else \
        tuple(bool(v) for v in host_mask(valid_parity))
    m_l = ys.shape[-1]
    mid = ys.shape[1:-1]
    esel, coef, gen = decode_plan(spec, vh, vph, m_l, str(ys.device))
    out = cdc_decode_merge(ys.reshape(T, -1, m_l).contiguous(),
                           parity.reshape(parity.shape[0], -1,
                                          parity.shape[-1]).contiguous(),
                           spec.layout, T, r, gen, esel, coef, vh)
    return out.reshape(mid + (T * m_l,))
