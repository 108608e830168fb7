"""One run of one cell: set-up, warm-up, the measured window, the traced
readings, the correctness check, the result line.

The window drives the port's ``ContinuousBatchingScheduler.step`` on the
wall clock (``runtime.clock.WallClock``) from the harness's client loop,
over ``SlotPoolExecutor`` and ``VStep.round`` (the fused round, replayed
as a CUDA graph on a card). The harness submits each request through
``sched.submit`` and reads each token as it reaches the host.
"""
from __future__ import annotations

import gc
import sys
import time

import torch

from harness import cells, check, probes, weights
from harness.ledger import Ledger

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROFILE_MS = 6e3          # the traced stretch of the window, at most


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Run:
    def __init__(self, cell: str | dict, seed: int, seconds: float,
                 trace: bool, device: str | torch.device = "cuda",
                 t_start: float | None = None,
                 cfg: dict | None = None, mix: dict | None = None):
        """``cell`` names a cell (or is one, with ``cfg`` and ``mix`` its
        configuration and traffic mix, as the CPU tests give them)."""
        self.t_start = time.monotonic() if t_start is None else t_start
        self.cell = cells.workload(cell) if isinstance(cell, str) else cell
        self.cfg = cfg or cells.config(self.cell["config"])
        self.mix = mix or cells.mix(self.cell["traffic"])
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = torch.device(device)
        names = self.cell["per_layer"] if trace else self.cell["end_to_end"]
        self.metrics = {n: cells.module("metrics", n) for n in names}
        self.events: dict = {}
        self.profile = None
        self.ranges: dict | None = None
        self.marks: list[tuple[str, float]] = []    # set-up's parts
        self.counters0 = self.counters1 = None
        self.window = (0.0, 0.0)
        self.setup_s = None
        self.control = False      # bench/control.py reads the control too

    def mark(self, part: str):
        """Note the end of a part of the set-up (seconds since start)."""
        self.marks.append((part, time.monotonic() - self.t_start))

    # ----------------------------------------------------------- set-up ----
    def setup(self):
        from repro_torch.models import TPCtx, build
        from repro_torch.runtime import (ContinuousBatchingScheduler,
                                         RuntimeConfig,
                                         ShardHealthController)
        from repro_torch.runtime.clock import WallClock
        from repro_torch.serve import ModelStepper
        self.mark("imports")
        tf32 = bool(self.cfg.get("tf32", False))
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        if self.device.type == "cuda":
            from repro_torch.kernels import build as kbuild
            kbuild.build_all()
        self.mark("kernels")
        self.arch = cells.port_arch(self.cfg)
        code = self.cfg["code"]
        ctx = TPCtx(tp=code["T"], mode="coded", code_r=code["r"],
                    code_layout=code["layout"],
                    moe_capacity=self.cfg.get("moe_capacity", 0))
        model = build(self.arch, ctx)
        self.params, _ = weights.make(model, self.seed, self.device,
                                      self.arch.vocab)
        self.mark("weights")
        stepper = ModelStepper(model, self.params,
                               max_len=self.cell["max_len"])
        self.mark("parity encode")
        self.clock = WallClock()
        health = ShardHealthController(stepper.n_shards,
                                       stepper.erasure_budget)
        self.sched = ContinuousBatchingScheduler(
            stepper, RuntimeConfig(n_slots=self.cell["slots"],
                                   seed=self.seed % (1 << 32)),
            clock=self.clock, health=health)
        self.ledger = Ledger()
        kind = cells.module("traffic/kinds", self.mix["kind"])
        self.traffic = kind.Traffic(self.mix["params"], self.seed,
                                    self.arch.vocab)
        for mod in self.metrics.values():
            install = getattr(mod, "install", None)
            if install is not None:
                install(self)
        if self.trace:
            probes.label_host(self)

    # ----------------------------------------------------------- window ----
    def serve(self):
        sched, ledger, clock = self.sched, self.ledger, self.clock
        self.traffic.start(sched, ledger, clock.now())
        # the first step admits the first wave (a prefill each) and
        # captures the first graph; the warm-up counts from its end
        finished = self._step()
        self.mark("first step")
        w0 = clock.now() + float(self.cell["warmup_s"]) * 1e3
        prof_at = prof_end = None
        started = False
        while True:
            self.traffic.pump(sched, ledger, clock.now(), finished)
            finished = self._step()
            t = clock.now()
            if not started:
                if t < w0:
                    continue
                started, w0 = True, t
                self.window = (w0, float("inf"))
                self.mark("warm-up")
                self.setup_s = time.monotonic() - self.t_start
                self.counters0 = dict(sched.metrics.counters)
                if self.trace:
                    prof_at = w0 + 0.35 * self.seconds * 1e3
                continue
            if prof_at is not None and self.profile is None \
                    and t >= prof_at:
                self.profile = probes.Profile()
                self.profile.start()
                prof_end = t + min(PROFILE_MS, 0.3 * self.seconds * 1e3)
            elif prof_end is not None and not self.profile.stopped \
                    and t >= prof_end:
                self.profile.stop()
            if t >= w0 + self.seconds * 1e3:
                break
        self.window = (w0, t)
        self.counters1 = dict(sched.metrics.counters)
        if self.profile is not None and not self.profile.stopped:
            self.profile.stop()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.memory_peak = torch.cuda.max_memory_allocated()
        else:
            self.memory_peak = 0
        self.shed = len(sched.shed)

    def _step(self) -> list:
        """One scheduler step; returns the requests that completed."""
        if not self.sched.busy:
            raise RuntimeError("nothing in flight")
        self.sched.step()
        return self.ledger.observe(self.clock.now())

    def after_window(self):
        """Traced readings that run after the window: the eager ranges,
        when a metric of the cell asks for them."""
        if self.trace and any(getattr(m, "RANGES", False)
                              for m in self.metrics.values()):
            self.ranges = probes.eager_ranges(self)

    # ------------------------------------------------------------ check ----
    def check(self) -> dict:
        """Free the program, then judge its served tokens against the
        plain reference."""
        spec = self.cell["check"]
        requests = check.sample(self.ledger.done,
                                list(self.ledger.live.values()), self.seed,
                                spec["tokens"], spec["max_requests"])
        self._free_program()
        reference = cells.module("reference", self.cfg["reference"])
        t = time.monotonic()
        self.readings = check.readings(reference, self.cfg, self.params,
                                       requests, self.device,
                                       control=self.control)
        self.check_s = time.monotonic() - t
        self.checks = check.judge(spec, self.readings)
        if self.control:
            # the control put in the program's place, judged alike
            self.control_checks = check.judge(
                spec, check.as_program(self.readings))
        return self.checks

    def _free_program(self):
        # the ledger keeps its Request objects (host tokens only); the
        # scheduler, the stepper's parity, the executor's state and
        # graphs go
        self.sched.executor.drop_pending()
        self.sched = None
        self.traffic = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    @property
    def correct(self) -> bool:
        return check.passes(self.checks)

    # ----------------------------------------------------------- result ----
    def attempted_failed(self) -> tuple[int, int]:
        # every request in flight at some time of the window
        w0, w1 = self.window
        done_before = {r.rid for t, r in self.ledger.done if t <= w0}
        n = sum(1 for rid, d in self.ledger.due.items()
                if d <= w1 and rid not in done_before)
        return n, self.shed

    def result(self) -> dict:
        metrics = {}
        for name, mod in self.metrics.items():
            value = mod.read(self)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
        attempted, failed = self.attempted_failed()
        device = {"platform": "gpu" if self.device.type == "cuda" else
                  self.device.type,
                  "kind": torch.cuda.get_device_name(0)
                  if self.device.type == "cuda" else "cpu",
                  "count": 1, "memory_peak_bytes": int(self.memory_peak)}
        out = {"correct": self.correct, "attempted": attempted,
               "failed": failed, "metrics": metrics, "device": device}
        if self.trace and self.profile is not None:
            s = self.profile.read()
            device["busy_s"], device["window_s"] = s["busy_s"], s["window_s"]
            out["breakdown"] = {"device_ops": s["device_ops"],
                                "idle_gaps": s["idle_gaps"]}
        out["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                         for k, v in self.checks.items()}
        return out


def _power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip() or "not read"


def report_lines(run):
    """Earlier lines of the standard output: each rate's and tail's
    median and sample count, the set-up's parts, the counters over the
    window."""
    from harness import stats
    w0, w1 = run.window
    led = run.ledger
    gaps = led.gaps_in(w0, w1)
    print(f"bench: cell {run.cell['name']} seed {run.seed} window "
          f"{(w1 - w0) / 1e3:.3f} s; card {_power_limit()}")
    print(f"bench: setup_s {run.setup_s:.3f}; tokens delivered "
          f"{led.tokens_in(w0, w1)}; itl median "
          f"{stats.median(gaps)} ms, p95 {stats.percentile(gaps, 95)} ms, "
          f"p99 {stats.percentile(gaps, 99)} ms over {len(gaps)} gaps")
    parts, prev = [], 0.0
    for part, t in run.marks:
        parts.append(f"{part} {t - prev:.3f}")
        prev = t
    print(f"bench: set-up by part (s): {'; '.join(parts)}")
    diff = {k: v - run.counters0.get(k, 0)
            for k, v in run.counters1.items()
            if v != run.counters0.get(k, 0)}
    print(f"bench: counters over the window {diff}; peak "
          f"{run.memory_peak} bytes")


Run.report_lines = report_lines
