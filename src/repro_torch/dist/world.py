"""Start a world of ranks, one process a rank, and collect their results.

``spawn_world(fn, n)`` starts n processes with ``torch.multiprocessing``
(spawned, so a parent that holds a CUDA context can start them), joins
them into one ``torch.distributed`` world through a ``file://`` store in a
fresh temporary directory (no TCP port: several worlds may run side by
side), calls ``fn(rank, n, *args)`` in each and returns the ranks' results
in rank order. Nothing is caught: a rank that raises makes ``spawn_world``
raise ``RankFailed`` with the traceback of the rank that failed first (the
other ranks are ended; those that failed after it, on its closed
connections, only followed it), and a world
that is still running at its deadline is killed and raises
``TimeoutError``. Each rank runs one intra-op thread.

On the card every rank loads the kernels that were built before the world
started (``kernels.build.forbid_builds``): the libraries under ``build/``
named by their sources' hash. A rank never compiles, so ranks cannot race
to rebuild a library.
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

__all__ = ["spawn_world", "RankFailed"]


class RankFailed(RuntimeError):
    """A rank of a world raised: the first to fail, with its traceback
    (the ranks that failed after it, on the dead rank's closed
    connections, are left out)."""


def _rank_main(rank: int, fn, n: int, backend: str, device: str,
               store: str, out_dir: str, timeout_s: float) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    if device == "cuda":
        from repro_torch.kernels import build
        torch.cuda.set_device(rank % torch.cuda.device_count())
        build.forbid_builds()
    dist.init_process_group(
        backend, init_method=store, world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, n, *args)
        dist.barrier()
    except BaseException:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _first_failure(out_dir: str, n: int) -> str | None:
    """"rank r failed: <traceback>" of the rank whose exception came
    first, or None when no rank recorded one (it was killed)."""
    seen = []
    for r in range(n):
        path = os.path.join(out_dir, f"error{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                when, _, tb = f.read().partition("\n")
            seen.append((float(when), r, tb))
    if not seen:
        return None
    _, r, tb = min(seen)
    return f"rank {r} of {n} failed first:\n{tb}"


def spawn_world(fn, n: int, *, backend: str = "gloo", device: str = "cuda",
                timeout_s: float = 300.0, args: tuple = ()) -> list:
    """``[fn(0, n, *args), ..., fn(n - 1, n, *args)]``, each run in its own
    process of an n-rank ``backend`` world. ``fn`` and ``args`` must be
    picklable (a module-level function). device "cuda" puts rank r on card
    r % device_count (every rank on the one card of a one-card machine);
    "cpu" touches no card."""
    out_dir = tempfile.mkdtemp(prefix="repro_world_")
    store = "file://" + os.path.join(out_dir, "store")
    deadline = time.monotonic() + timeout_s
    # the arguments go through a file: a spawned process reads what it is
    # handed through a pipe only once its interpreter is up, so large
    # arguments in the pipe would start the ranks one after another
    with open(os.path.join(out_dir, "args.pkl"), "wb") as f:
        pickle.dump(tuple(args), f)
    ctx = mp.start_processes(
        _rank_main, args=(fn, n, backend, device, store, out_dir, timeout_s),
        nprocs=n, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"a world of {n} ranks was still running "
                                   f"at its {timeout_s} s deadline")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    except ProcessException as e:
        first = _first_failure(out_dir, n)
        if first is None:
            raise
        raise RankFailed(first) from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(out_dir, ignore_errors=True)
