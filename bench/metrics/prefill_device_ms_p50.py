"""prefill_device_ms_p50: a prefill's latency on the device's timeline,
from the port's own CUDA event pair around ``ModelStepper.prefill``
(``serve/engine.py``; read once the first token is on the host:
``host.admit``'s ``device_ms``), the median over the admissions that
began in the window. The in-program counterpart of ``prefill_ms_p50``.
Layer: prefill."""
from harness import recorder, stats

UNIT = "ms"
install = recorder.install


def read(run):
    return stats.median(recorder.device_ms(run, "host.admit"))
