"""prefill_mamba_ms_p50: the device ms of a prefill's Mamba-2 mixers,
from the port's own CUDA event pair around each Mamba-2 mixer of a
prefill (``models/transformer.py``, a ``prefill.mamba`` device range
inside ``ModelStepper.prefill``'s forward), summed per prefill and read
once the first token is on the host (the ``prefill.mamba`` event's
``device_ms``); the median over the admissions that began in the window.
Layer: Mamba-2 mixer."""
from harness import recorder, stats

UNIT = "ms"
install = recorder.install


def read(run):
    return stats.median(recorder.device_ms(run, "prefill.mamba"))
