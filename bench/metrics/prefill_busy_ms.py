"""prefill_busy_ms: the device's busy ms of a prefill, from the traced
stretch of the window (torch.profiler): the time of every device
operation launched inside a ``serve/engine.py`` ``ModelStepper.prefill``
call, matched to its launch by the profiler's correlation id; the median
over the prefills the stretch holds whole. Unlike ``prefill_ms_p50`` it
leaves out the host's gaps between launches. Layer: prefill."""
from harness import stats

UNIT = "ms"


def read(run):
    s = run.profile.read() if run.profile is not None else None
    return stats.median(s["prefill_busy_ms"]) if s else None
