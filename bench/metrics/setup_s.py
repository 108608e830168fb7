"""setup_s: process start to the window's start (the first timed
request): imports, kernel builds or loads, weights, the parity encode,
the first graph capture and the warm-up traffic. Host clock."""
UNIT = "s"


def read(run):
    return run.setup_s
