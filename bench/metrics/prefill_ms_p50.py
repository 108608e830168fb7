"""prefill_ms_p50: the latency of a prefill on the device's timeline, CUDA
events recorded before and after each call of ``serve/engine.py``
``ModelStepper.prefill`` (into ``models/``) that began in the window; the
median. The prefill is launched eagerly and its launches are host-bound,
so this holds the host's gaps between kernels as well as their work; the
device's own time is ``prefill_busy_ms``. Layer: prefill."""
from harness import readers

UNIT = "ms"
install = readers.install_prefill
read = readers.prefill_ms_median
