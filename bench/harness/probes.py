"""The benchmark's own spans around the port's entry points, installed on
the instances of one run from outside the port (nothing in ``src/``
changes). Device time is keyed by the range of an entry point, never by
a kernel's name, so a later change that replaces a kernel stays
measured.

  * ``timed(run, obj, attr, key)``: CUDA events around every call of
    ``obj.attr``, kept with the host time at which the call began;
  * ``Profile``: torch.profiler over a steady stretch of the window, read
    into the device's busy seconds, the kernels that took most time, the
    idle gaps by the host range they fell in, and the device time of the
    work each prefill launched;
  * ``eager_ranges``: after the window, a few eager fused rounds with
    CUDA events around each call of the named entry points, read into
    device time against the least time their work needs (``costs``).
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from harness import costs

SPIN_CYCLES = 4_000_000     # ~2 ms at the H100's clocks: covers an enqueue
PREFILL = "host.prefill"    # the range around ModelStepper.prefill
# host ranges that label the device's idle gaps: (label, owner, method)
HOST_RANGES = (("host.health", "sched", "_handle_health"),
               ("host.admit_prefill", "sched", "_admit"),
               (PREFILL, "stepper", "prefill"),
               ("host.round_dispatch", "executor", "_dispatch"),
               ("host.harvest_wait", "executor", "_harvest"),
               ("host.reencode", "stepper", "reencode"),
               ("host.ledger", "ledger", "observe"),
               ("host.traffic", "traffic", "pump"))


def _wrap(obj, attr, around):
    """Replace ``obj.attr`` on the instance by ``around(fn, *a, **kw)``;
    idempotent per (obj, attr, around)."""
    fn = getattr(obj, attr)
    if getattr(fn, "_bench_around", None) is around:
        return
    def call(*a, **kw):
        return around(fn, *a, **kw)
    call._bench_around = around
    setattr(obj, attr, call)


def timed(run, obj, attr: str, key: str):
    """CUDA events around each call of ``obj.attr``; the pairs land in
    ``run.events[key]`` as (host start ms on the run's clock, start,
    end)."""
    if key in run.events:
        return
    pairs = run.events[key] = []

    def around(fn, *a, **kw):
        t = run.clock.now()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **kw)
        end.record()
        pairs.append((t, start, end))
        return out
    _wrap(obj, attr, around)


def event_ms(run, key: str) -> list[float]:
    """Device ms of each call of ``key`` that began inside the window."""
    torch.cuda.synchronize()
    w0, w1 = run.window
    return [s.elapsed_time(e) for t, s, e in run.events.get(key, ())
            if w0 < t <= w1]


def label_host(run):
    """record_function ranges around the host's parts of a step, so an
    idle gap on the device can be put down to what the host was doing."""
    owners = {"sched": run.sched, "executor": run.sched.executor,
              "stepper": run.sched.stepper, "ledger": run.ledger,
              "traffic": run.traffic}
    for label, owner, attr in HOST_RANGES:
        def around(fn, *a, _label=label, **kw):
            with torch.profiler.record_function(_label):
                return fn(*a, **kw)
        _wrap(owners[owner], attr, around)


def _union(intervals) -> float:
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


class Profile:
    """torch.profiler over a stretch of the window, both ends synchronised."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.summary = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    @property
    def stopped(self) -> bool:
        return self.t1 is not None

    def read(self) -> dict:
        """The summary; the trace is read once, after the window."""
        if self.summary is None:
            self.summary = self._read()
            self.prof = None
        return self.summary

    def _read(self) -> dict:
        cuda = torch.autograd.DeviceType.CUDA
        events = self.prof.events()
        dev, host, launch = [], [], {}
        for e in events:
            if getattr(e, "is_user_annotation", False) \
                    or e.name.startswith(("host.", "bench.")):
                if e.device_type != cuda:
                    host.append((e.time_range.start, e.time_range.end,
                                 e.name))
                continue
            if e.device_type == cuda:
                dev.append((e.time_range.start, e.time_range.end, e.name,
                            e.id))
            elif e.name.startswith("cu"):
                # a CUDA runtime or driver call: the host time of a
                # launch, under the correlation id its device work carries
                launch[e.id] = e.time_range.start
        busy_us = _union((a, b) for a, b, _, _ in dev)
        by_op: dict[str, float] = {}
        for a, b, name, _ in dev:
            by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e6
        # idle gaps between merged busy stretches, by the innermost host
        # range open at the gap's middle
        gaps, end = [], None
        for a, b, _, _ in sorted(dev):
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        by_host: dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) / 2
            inner = [(hs, name) for hs, he, name in host if hs <= mid <= he]
            label = max(inner)[1] if inner else "host.other"
            by_host[label] = by_host.get(label, 0.0) + (b - a) / 1e6
        top = lambda d: [[k, v] for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"busy_s": busy_us / 1e6, "window_s": self.t1 - self.t0,
                "device_ops": top(by_op), "idle_gaps": top(by_host),
                "n_device_events": len(dev),
                "prefill_busy_ms": launched_ms(
                    dev, launch, [(a, b) for a, b, name in host
                                  if name == PREFILL])}


def launched_ms(dev, launch: dict, ranges) -> list[float]:
    """Device ms of the work launched inside each host range: every
    device event (start, end, name, correlation id) whose launch's host
    time lies in the range; one without a launch on record counts where
    it starts. Only ranges the trace holds whole are given."""
    out = []
    for a, b in sorted(ranges):
        us = 0.0
        for s, e, _, cid in dev:
            t = launch.get(cid, s)
            if a <= t <= b:
                us += e - s
        out.append(us / 1e3)
    return out


@contextlib.contextmanager
def _evented(module, attr: str, before, spans: list):
    """``module.attr`` replaced by a call that counts its work
    (``before``) and records CUDA events around it into ``spans``. A spin
    kernel holds the stream while the host enqueues the call, so the
    events time the device's work and not the host's launch overhead."""
    fn = getattr(module, attr)

    def call(*a, **kw):
        before(*a, **kw)
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **kw)
        end.record()
        spans.append((start, end))
        return out
    setattr(module, attr, call)
    try:
        yield
    finally:
        setattr(module, attr, fn)


def eager_ranges(run, n_rounds: int = 4) -> dict:
    """Eager fused rounds of the pool as the window left it, under the
    full mask, with CUDA events around each call of kernel 1's entry
    (``kernels.ops.fused_coded_matmul``) and of the routed experts
    (``models.ffn._moe_local``). Returns {name: {"device_s", "least_s",
    "calls"}} for each entry that was called."""
    from repro_torch.kernels import ops
    from repro_torch.models import ffn
    ex = run.sched.executor
    least = {"coded_gemm": [0.0, 0], "moe_experts": [0.0, 0]}
    spans = {"coded_gemm": [], "moe_experts": []}

    def gemm_work(x, w, w_cdc, spec, valid, **kw):
        k, m = w.shape
        least["coded_gemm"][0] += costs.least_seconds(*costs.coded_gemm(
            x.numel() // k, k, m, w_cdc.numel(), x.element_size()))
        least["coded_gemm"][1] += 1

    def moe_work(ctx, p, xf, e, k):
        probs = torch.softmax((xf @ p["router"]["w"]).float(), dim=-1)
        hit = int(torch.unique(torch.topk(probs, k, dim=-1).indices).numel())
        d, fe = p["we1"].shape[-2:]
        least["moe_experts"][0] += costs.least_seconds(*costs.moe_experts(
            xf.shape[0], d, fe, e, k, hit, xf.element_size()))
        least["moe_experts"][1] += 1

    valid = np.ones(run.sched.stepper.n_shards, bool)
    graphs, ex.vstep.use_graphs = ex.vstep.use_graphs, False
    ex.drop_pending()
    try:
        with _evented(ops, "fused_coded_matmul", gemm_work,
                      spans["coded_gemm"]), \
                _evented(ffn, "_moe_local", moe_work, spans["moe_experts"]):
            ex.step_round(valid)                     # warm, not counted
            for name in least:
                least[name] = [0.0, 0]
                spans[name].clear()
            for _ in range(n_rounds):
                ex.step_round(valid)
            torch.cuda.synchronize()
    finally:
        ex.vstep.use_graphs = graphs
        ex.drop_pending()
    return {name: {"device_s": sum(s.elapsed_time(e)
                                   for s, e in spans[name]) / 1e3,
                   "least_s": least[name][0], "calls": least[name][1]}
            for name in least if least[name][1]}
