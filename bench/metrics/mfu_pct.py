"""mfu_pct: useful model FLOPs of the window's delivered tokens (prefill
for a first token, decode over the real context for any other; active
parameters only, no parity, no padding; ``harness.costs``), over the
window times the float32 peak of 67 TFLOP/s. Layer: the model, round
and prefill (``models/``)."""
from harness import peaks, readers

UNIT = "%"


def read(run):
    return 100.0 * readers.window_flops(run) / (
        readers.window_s(run) * peaks.F32_FLOPS)
