"""round_device_ms: device ms of a decode round, from the port's own CUDA
event pair around ``VStep.round`` (``runtime/executor/pool.py``, read at
the round's harvest: ``round.harvest``'s ``device_ms``), the mean over
the rounds harvested in the window. The in-program counterpart of
``decode_round_ms``. Layer: executor round."""
from harness import recorder

UNIT = "ms"
install = recorder.install


def read(run):
    ms = recorder.device_ms(run, "round.harvest")
    return sum(ms) / len(ms) if ms else None
