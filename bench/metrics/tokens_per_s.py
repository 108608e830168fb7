"""tokens_per_s: output tokens that reached the clients in the window,
each request's position counted once (not again after a requeue), over
the window. Host clock, delivery after ``sched.step()`` returns."""
from harness import readers

UNIT = "tokens/s"


def read(run):
    w0, w1 = run.window
    return run.ledger.tokens_in(w0, w1) / readers.window_s(run)
