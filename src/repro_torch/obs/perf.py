"""Perf observability: roofline-anchored cost attribution for live rounds.

The port's copy of the reference package's ``obs/perf.py``, with the cost
counted on torch instead of compiled HLO. ``PerfMonitor`` connects the
measured round latency (``SlotPoolExecutor.round_ms``) with the least time
the card could take for the same round:

  * **Attribution** (once per code geometry): one eager round of each
    variant the executor owns — ``reference`` (full-logits coded decode)
    and ``fused`` (the kernels' round, the one its CUDA graph replays) —
    runs on a clone of the slot state (made before counting starts: a
    round reads its state in place, so an enc-dec's bank, a hybrid's
    mamba state or xLSTM's block states count as the round moves them,
    never as a copy) under a counting ``TorchDispatchMode``: dot FLOPs of
    every matmul / bmm (einsum and tensordot reach them), bytes of every
    launched op's operands and outputs (a gather or scatter counts the
    rows it moves, not the whole table; an ``out=`` tensor is written, not
    read; views and allocations launch nothing; an MoE layer's batched
    expert products read every expert's weights, as its dense dispatch
    does, and its routing sorts count their keys and indices), and each
    kernel wrapper's own report (``kernels.accounting``: its
    ``KERNEL_COSTS`` FLOPs and its operand-plus-output bytes; the torch
    ops inside a wrapper are not counted, so the CPU, where a wrapper runs
    its plain version, and the card count the same). The same round
    through the PLAIN model on the raw params gives ``useful_flops``; the
    difference is the parity work the code adds:

        coded_overhead_frac = parity_flops / total_flops
                            ≈ r/(T+r) · gemm_share   (falls with T)
        parity_device_equiv = parity_flops / (useful_flops / T)
                            ≈ r · gemm_share         (FLAT in T)

    The cost rounds launch real kernels on the card; their launches are
    kept out of the wrappers' counts (``accounting.uncounted``), and they
    never run inside a CUDA-graph capture (attribution happens at a
    harvest).
  * **Utilization** (every harvest): the static per-round cost with the
    MEASURED round wall time gives ``achieved_flops_per_s``, ``hbm_gbs``
    and ``roofline_utilization`` (= bound time / measured time; 1.0 is a
    round at the card's bound). Published through ``RuntimeMetrics.perf``,
    ``perf.counter`` events on the flight recorder's ``perf`` track
    (static cost in args, wall-derived values in ``wall_args``) and
    ``summary()``.

The bound is one H100's (``roofline.analysis``), at the float32 or bf16
peak by the params' storage type; one card moves no wire bytes.
``custom_calls_uncosted`` counts kernel launches with no cost model
(0 when every wrapper is registered in ``KERNEL_COSTS``).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import accounting, ops
from repro_torch.obs.tracer import NULL_RECORDER
from repro_torch.roofline.analysis import hw_for, roofline_terms

aten = torch.ops.aten
_DOTS = {aten.mm: 0, aten.bmm: 0, aten.addmm: 1, aten.baddbmm: 1,
         aten.mv: 0, aten.dot: 0}        # op -> index of its first factor
_GATHERS = {aten.index, aten.index_select, aten.embedding, aten.gather}
_SCATTERS = {aten.index_put, aten.index_put_, aten._index_put_impl_}
# allocations and views whose schema marks no alias (``_unsafe_view``: the
# reshape that follows a copy) launch nothing
_NO_KERNEL = {aten.empty, aten.empty_strided, aten.empty_like,
              aten.new_empty, aten.new_empty_strided, aten.lift_fresh,
              aten._local_scalar_dense, aten.resize_, aten.set_,
              aten._unsafe_view}


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class CostCounter(TorchDispatchMode):
    """FLOPs and bytes of the ops run under it, plus the kernel wrappers'
    own reports (install with ``accounting.counting(counter)``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.custom_calls_uncosted = 0
        self.kernels: dict[str, int] = {}
        self._depth = 0

    @contextlib.contextmanager
    def inside_kernel(self):
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1

    def kernel(self, name: str, arguments: dict, result):
        self.kernels[name] = self.kernels.get(name, 0) + 1
        cost = ops.kernel_cost(name, arguments, result)
        if cost is None:
            self.custom_calls_uncosted += 1
            return
        self.flops += cost[0]
        self.bytes += cost[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._depth == 0:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        pkt = func.overloadpacket
        if pkt in _NO_KERNEL or _is_view(func):
            return
        outs = _tensors(out)
        if pkt in _DOTS:
            a = args[_DOTS[pkt]]
            self.flops += 2.0 * sum(o.numel() for o in outs) * a.shape[-1]
        if pkt in _GATHERS:
            # read the gathered rows and the indices, write the result
            idx = [t for t in _tensors(args[1:]) if not t.is_floating_point()]
            self.bytes += 2 * _nbytes(outs) + _nbytes(idx)
        elif pkt in _SCATTERS:
            # read the values and the indices, write the values
            vals = args[2]
            self.bytes += 2 * _nbytes([vals]) + _nbytes(_tensors(args[1]))
        else:
            ins = {k: v for k, v in kwargs.items() if k != "out"}
            self.bytes += _nbytes(_tensors((args, ins))) + _nbytes(outs)


@contextlib.contextmanager
def counted():
    """A fresh ``CostCounter`` over the block, the kernel wrappers
    reporting to it; their launches stay out of the wrappers' counts. The
    caller's grad mode holds (under grad mode a backward counts too)."""
    counter = CostCounter()
    with accounting.uncounted(), accounting.counting(counter), counter:
        yield counter


def count_round(fn) -> CostCounter:
    """Run ``fn()`` once under ``counted()``, without grad."""
    with counted() as counter, torch.no_grad():
        fn()
    return counter


@dataclasses.dataclass(frozen=True)
class RoundCost:
    """Static per-dispatch cost of one round variant."""
    variant: str
    flops: float                 # total dot FLOPs per dispatch
    bytes: float                 # device bytes per dispatch
    wire_bytes: float            # 0: one card
    useful_flops: float          # the plain (uncoded) model's FLOPs
    parity_flops: float          # flops - useful_flops (>= 0)
    coded_overhead_frac: float   # parity / total: falls as T grows
    parity_device_equiv: float   # parity / (useful / T): flat in T (Fig. 2)
    T: int
    r: int
    bound_step_s: float          # roofline-bound round time on the card
    dominant: str                # compute | memory | collective
    custom_calls_uncosted: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _clone_state(state):
    # runtime imports obs (the tracer), so obs imports runtime late
    from repro_torch.runtime.executor.slotbatch import clone_state
    return clone_state(state)


def _count_on_clones(fn, state, toks, valid) -> CostCounter:
    """``count_round`` of ``fn(state, toks, valid)`` on clones of the slot
    state and tokens, made before counting starts: a round reads its state
    in place, so the copy is no part of it (an enc-dec's state holds the
    whole cross-attention bank)."""
    state, toks = _clone_state(state), toks.clone()
    return count_round(lambda: fn(state, toks, valid))


def _plain_round(stepper, state, toks) -> CostCounter:
    """The identical round through the PLAIN model on the RAW (uncoded)
    params: slot state is code-mode independent."""
    model = stepper.model
    pmodel = dataclasses.replace(
        model, ctx=dataclasses.replace(model.ctx, mode="plain",
                                       fused_body=False))

    def run(state, toks, valid):
        logits, _ = pmodel.decode(stepper._raw_params, state, toks, valid)
        torch.argmax(logits[:, -1:], dim=-1)

    return _count_on_clones(run, state, toks, None)


def attribute_round_costs(vstep, state, toks, hw: dict | None = None
                          ) -> dict[str, RoundCost]:
    """Cost every round variant of ``vstep`` over the given slot state
    (which is cloned, never advanced). Returns {variant: RoundCost} —
    always ``reference``, plus ``fused`` when the executor dispatches the
    kernels' round."""
    st = vstep.stepper
    hw = dict(hw or hw_for(st._raw_params["lm_head"]["w"].dtype))
    coded = bool(st.coded)
    T = int(st.n_shards)
    r = int(st.model.ctx.code_r) if coded else 0
    valid = st._mask(st.full_mask()) if coded else None

    raw = {"reference": _count_on_clones(vstep._round, state, toks, valid)}
    if vstep.use_fused and coded:
        raw["fused"] = _count_on_clones(vstep._round_fused, state, toks,
                                        valid)
    useful = raw["reference"].flops if not coded \
        else _plain_round(st, state, toks).flops

    out: dict[str, RoundCost] = {}
    for variant, cost in raw.items():
        flops = float(cost.flops)
        parity = max(flops - useful, 0.0)
        terms = roofline_terms({"flops": flops, "bytes accessed": cost.bytes},
                               None, hw)
        out[variant] = RoundCost(
            variant=variant, flops=flops, bytes=float(cost.bytes),
            wire_bytes=0.0, useful_flops=float(useful),
            parity_flops=parity,
            coded_overhead_frac=parity / flops if flops else 0.0,
            parity_device_equiv=(parity / (useful / T)
                                 if coded and useful else 0.0),
            T=T, r=r, bound_step_s=float(terms["bound_step_s"]),
            dominant=str(terms["dominant"]),
            custom_calls_uncosted=float(cost.custom_calls_uncosted))
    return out


class PerfMonitor:
    """Per-round achieved-vs-roofline accounting for a slot-pool executor.

    Wired by ``SlotPoolExecutor`` when ``RuntimeConfig.perf`` is on:
    attribution runs at the first harvest and again whenever the
    planner's ``set_code_r`` changes the (T, r) geometry; every harvest
    then feeds the measured round period through ``observe_round``.
    """

    def __init__(self, metrics=None, tracer=None, hw: dict | None = None):
        self.metrics = metrics
        self.tracer = tracer if tracer is not None else NULL_RECORDER
        self.hw = dict(hw) if hw else None
        self.costs: dict[str, RoundCost] = {}
        self.n_observed = 0
        self.n_attributions = 0
        self.last_variant: str | None = None
        self.last_round_ms: float | None = None
        self._geom: tuple[int, int] | None = None

    # ------------------------------------------------------- attribution ----
    def attribute(self, executor) -> dict[str, RoundCost]:
        st = executor.stepper
        self.costs = attribute_round_costs(
            executor.vstep, executor.state, executor.last_toks, hw=self.hw)
        self.n_attributions += 1
        self._geom = (int(st.n_shards),
                      int(st.model.ctx.code_r) if st.coded else 0)
        if self.tracer.enabled:
            for cost in self.costs.values():
                # deterministic: everything here is counted from shapes
                self.tracer.emit(
                    "perf.attribution", track="perf",
                    variant=cost.variant, flops=cost.flops,
                    hbm_bytes=cost.bytes, wire_bytes=cost.wire_bytes,
                    useful_flops=cost.useful_flops,
                    parity_flops=cost.parity_flops,
                    coded_overhead_frac=cost.coded_overhead_frac,
                    parity_device_equiv=cost.parity_device_equiv,
                    T=cost.T, r=cost.r, dominant=cost.dominant,
                    bound_step_us=cost.bound_step_s * 1e6)
        if self.metrics is not None:
            self.metrics.set_perf(self._static_summary())
        return self.costs

    def _maybe_attribute(self, executor):
        st = executor.stepper
        geom = (int(st.n_shards),
                int(st.model.ctx.code_r) if st.coded else 0)
        if geom != self._geom:
            self.attribute(executor)

    # -------------------------------------------------------- observation ----
    def observe_round(self, executor, wall_ms: float, variant: str):
        """One harvested round: measured period ``wall_ms`` for the round
        ``variant`` that was dispatched."""
        self._maybe_attribute(executor)
        cost = self.costs.get(variant) or self.costs.get("reference")
        if cost is None or wall_ms <= 0:
            return
        self.n_observed += 1
        self.last_variant = variant
        self.last_round_ms = float(wall_ms)
        derived = self.derived(cost, wall_ms)
        if self.metrics is not None:
            self.metrics.set_perf({"variant": variant,
                                   "n_rounds_observed": self.n_observed,
                                   **derived})
        if self.tracer.enabled:
            self.tracer.emit(
                "perf.counter", track="perf",
                variant=variant,
                model_gflops=cost.useful_flops / 1e9,
                coded_overhead_frac=cost.coded_overhead_frac,
                parity_device_equiv=cost.parity_device_equiv,
                wall_args={
                    "round_ms": wall_ms,
                    "achieved_gflops_per_s":
                        derived["achieved_flops_per_s"] / 1e9,
                    "hbm_gbs": derived["hbm_gbs"],
                    "roofline_utilization":
                        derived["roofline_utilization"]})

    def derived(self, cost: RoundCost, round_ms: float) -> dict:
        """Achieved rates for one measured round period."""
        s = round_ms / 1e3
        return {
            "achieved_flops_per_s": cost.flops / s,
            "hbm_gbs": cost.bytes / s / 1e9,
            "roofline_utilization": cost.bound_step_s / s,
            "round_ms": float(round_ms),
        }

    # ------------------------------------------------------------ reading ----
    def _headline(self) -> RoundCost | None:
        if not self.costs:
            return None
        return self.costs.get(self.last_variant or "") \
            or self.costs.get("reference") \
            or next(iter(self.costs.values()))

    def _static_summary(self) -> dict:
        cost = self._headline()
        if cost is None:
            return {}
        return {
            "model_flops": cost.useful_flops,
            "hlo_flops": cost.flops,
            "hbm_bytes": cost.bytes,
            "wire_bytes": cost.wire_bytes,
            "parity_flops": cost.parity_flops,
            "coded_overhead_frac": cost.coded_overhead_frac,
            "parity_device_equiv": cost.parity_device_equiv,
            "bound_step_us": cost.bound_step_s * 1e6,
            "dominant": cost.dominant,
            "T": cost.T, "r": cost.r,
            "custom_calls_uncosted": cost.custom_calls_uncosted,
        }

    def summary(self, round_ms: float | None = None) -> dict:
        """One flat report row: static attribution + achieved rates at
        ``round_ms`` (defaults to the last observed round)."""
        cost = self._headline()
        if cost is None:
            return {}
        out = self._static_summary()
        out["variant"] = cost.variant
        out["n_rounds_observed"] = self.n_observed
        ms = round_ms if round_ms else self.last_round_ms
        if ms:
            out.update(self.derived(cost, ms))
        out["variants"] = {k: v.as_dict() for k, v in self.costs.items()}
        return out
