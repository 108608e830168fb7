"""Launch and cost accounting of the kernel wrappers.

Every public kernel wrapper is decorated with ``costed(name)``, which
registers it in ``WRAPPERS`` and makes it report its cost to the active
cost sink, if any. Two uses:

  * **Launch counts under CUDA-graph replay.** Each wrapper bumps its
    ``launches`` (and ``variants``) in Python where it launches its
    kernel. A replayed graph runs no Python, so the executor records what
    a capture added (``snapshot`` before, ``since`` after), puts the
    counters back (``restore``: a capture launches nothing) and adds the
    recorded increase on every replay (``credit``). ``uncounted()`` keeps
    side rounds (a warm-up before a capture, the perf monitor's cost
    round) out of the counts.
  * **Cost counting.** ``obs.perf`` installs a sink (``counting``) while
    it runs one eager round under a ``TorchDispatchMode``. A decorated
    wrapper then reports ``(name, bound arguments, result)`` to the sink
    and, while its body runs, the sink ignores the torch ops it sees: on
    the CPU the body is the kernel's plain version, whose ops would count
    twice. With no sink installed the decorator costs one branch.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import inspect
from typing import Any, Callable

WRAPPERS: dict[str, Callable] = {}       # wrapper name -> wrapper
_sink: Any = None                        # the active cost sink, or None


def costed(name: str):
    """Register a kernel wrapper under ``name`` and route its calls through
    the active cost sink."""
    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            sink = _sink
            if sink is None:
                return fn(*args, **kwargs)
            with sink.inside_kernel():
                out = fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            sink.kernel(name, bound.arguments, out)
            return out

        WRAPPERS[name] = wrapper
        return wrapper
    return wrap


@contextlib.contextmanager
def counting(sink):
    """Install ``sink`` (``inside_kernel()`` context, ``kernel(name,
    arguments, result)``) as the cost sink for the duration."""
    global _sink
    prev, _sink = _sink, sink
    try:
        yield sink
    finally:
        _sink = prev


def snapshot() -> dict[str, tuple[int, collections.Counter]]:
    """Every wrapper's launch count and launches per instantiation."""
    return {name: (fn.launches,
                   collections.Counter(getattr(fn, "variants", ())))
            for name, fn in WRAPPERS.items()}


def since(before: dict) -> dict[str, tuple[int, collections.Counter]]:
    """What the counters gained since ``before`` (a ``snapshot``)."""
    out = {}
    for name, (n, var) in snapshot().items():
        n0, var0 = before.get(name, (0, collections.Counter()))
        if n != n0 or var != var0:
            out[name] = (n - n0, var - var0)
    return out


def restore(before: dict) -> None:
    """Put every counter back to ``before`` (a ``snapshot``)."""
    for name, (n, var) in before.items():
        fn = WRAPPERS[name]
        fn.launches = n
        if hasattr(fn, "variants"):
            fn.variants.clear()
            fn.variants.update(var)


def credit(delta: dict) -> None:
    """Add a recorded increase (``since``) to the counters."""
    for name, (n, var) in delta.items():
        fn = WRAPPERS[name]
        fn.launches += n
        if hasattr(fn, "variants"):
            fn.variants.update(var)


@contextlib.contextmanager
def uncounted():
    """Run a block whose launches must not show in the counters."""
    before = snapshot()
    try:
        yield
    finally:
        restore(before)
