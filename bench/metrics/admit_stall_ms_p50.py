"""admit_stall_ms_p50: the stall one admission adds to every other slot's
next token, the wall ms of the port's ``host.admit`` span
(``runtime/scheduler.py``: from the request's pop to its first token on
the host with its slot's row written), the median over those that began
in the window. Layer: scheduler."""
from harness import recorder

UNIT = "ms"
install = recorder.install


def read(run):
    return recorder.wall_ms_median(run, "host.admit")
