"""prefill_launch_ms_p50: the host's enqueue of a prefill's forward, the
wall ms of the port's ``host.prefill.forward`` span (``serve/engine.py``
``ModelStepper.prefill``: ``model.decode`` over the prompt), the median
over those that began in the window. Near ``prefill_ms_p50``, the
launches set a prefill's pace; near ``prefill_busy_ms``, the device does.
Layer: prefill."""
from harness import recorder

UNIT = "ms"
install = recorder.install


def read(run):
    return recorder.wall_ms_median(run, "host.prefill.forward")
