"""roofline_pct.mamba2_step: one decode token's Mamba-2 state update,
``models/mamba2.py`` ``step`` (the conv window and the SSM state advanced
in place, the output read out): the least time its work needs
(``harness/mamba2_costs.py``: the SSM state and the conv window read once
and written once, the step's inputs, parameters and output once, at the
HBM bandwidth) over its device time, CUDA events around each call
(``probes.timed``) in the eager fused rounds ``probes.eager_ranges`` runs
after the window, its first round (the warm one) left out. Only those
rounds are timed: a graph capture records no timing event, and a prefill
does not call ``step``. Layer: Mamba-2 mixer."""
from harness import costs, mamba2_costs, probes

UNIT = "%"
RANGES = True
KEY = "mamba2_step"


def install(run):
    """Wrap the next ``probes.eager_ranges`` so that it times ``step``
    while it runs (and puts ``step`` back after)."""
    eager = probes.eager_ranges

    def ranges(r, *a, **kw):
        probes.eager_ranges = eager
        try:
            from repro_torch.models import mamba2
        except ImportError:            # a port without Mamba-2 layers
            return eager(r, *a, **kw)
        step = mamba2.step
        probes.timed(r, mamba2, "step", KEY)
        try:
            return eager(r, *a, **kw)
        finally:
            mamba2.step = step
    probes.eager_ranges = ranges


def _layers(cfg: dict) -> int:
    kinds = cfg.get("hybrid_override_pattern", "")
    return kinds[:cfg["num_hidden_layers"]].count("M")


def read(run):
    calls = run.events.get(KEY, [])[_layers(run.cfg):]
    if not calls:
        return None
    device_s = sum(s.elapsed_time(e) for _, s, e in calls) / 1e3
    least = len(calls) * costs.least_seconds(
        *mamba2_costs.step(run.cfg, run.cell["slots"]))
    return 100.0 * least / device_s if device_s > 0 else None
