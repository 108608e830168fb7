"""Atomic, async checkpointing in the reference's on-disk format.

A checkpoint of a tree of tensors is a directory ``step_XXXXXXXX/`` with
``manifest.json`` (the step and, per leaf in the reference's flattening
order, its name, file, shape and dtype) and one ``.npy`` per leaf, named
by the leaf's path (``params/layers/attn/wq/w`` -> ``params__layers__attn
__wq__w.npy``; ``#i`` for the i-th list item); bf16 is stored as a
``uint16`` view. So a checkpoint written by the port restores in the
reference and the other way round.

Properties:
  * atomic: writes into step_XXXXXXXX.tmp/, fsyncs the manifest, then
    os.replace -> step_XXXXXXXX
  * async: ``AsyncCheckpointer.save`` copies the tree to host memory and
    returns; a worker thread writes it (the train step updates the device
    tensors in place, so nothing of them may be read later)
  * CDC-aware: leaves whose path ends in ``/cdc`` (parity) are dropped on
    save and taken from the template on restore; ``encode_ctx`` re-encodes
    the parity after the load, the paper's offline preparation
  * on restore each leaf goes to ``device`` (the template leaf's device by
    default). The reference's mesh and sharding placement has no
    counterpart yet: the port trains on one device.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.tree import named_leaves, unflatten

_SENTINEL = object()


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the numpy array to store and its dtype's name (bf16 as
    its uint16 bits, named "bfloat16")."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(tree: Any, directory: str, step: int) -> str:
    """Synchronous atomic save of a tree of tensors (or numpy arrays);
    parity leaves (path ending in ``/cdc``) are not written."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "leaves": []}
    for name, leaf in named_leaves(tree):
        if name.endswith("/cdc"):
            manifest["leaves"].append(
                {"name": name, "kind": "parity"})  # re-encoded on load
            continue
        arr, dtype = _host(leaf)
        fn = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append(
            {"name": name, "kind": "array", "file": fn,
             "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _load(path: str, entry: dict) -> torch.Tensor:
    arr = np.load(os.path.join(path, entry["file"]))
    if entry["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != entry["dtype"]:
        arr = arr.astype(np.dtype(entry["dtype"]))
    return torch.from_numpy(arr)


def restore(template: Any, directory: str, step: int | None = None, *,
            device: str | torch.device | None = None,
            encode_ctx=None) -> Any:
    """Restore into the structure of ``template`` (values replaced).

    A leaf the checkpoint lacks, or a parity leaf, keeps the template's
    tensor. device: where the loaded leaves go (each template leaf's
    device when None). encode_ctx: a TPCtx — recompute every parity leaf
    from its base weight after the load (under no_grad: the encode is an
    offline step, never differentiated).
    """
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {e["name"]: e for e in manifest["leaves"]}

    out = []
    for name, tmpl in named_leaves(template):
        entry = by_name.get(name)
        if entry is None or entry["kind"] == "parity":
            out.append(tmpl)  # parity re-encoded below / missing kept
            continue
        dev = device if device is not None else (
            tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu")
        out.append(_load(path, entry).to(dev))
    tree = unflatten(template, out)
    if encode_ctx is not None and encode_ctx.coded:
        from repro_torch.models.common import encode_tree
        with torch.no_grad():
            tree = encode_tree(tree, encode_ctx)
    return tree


class AsyncCheckpointer:
    """Fire-and-forget background saves (training never stalls on I/O)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err: list[BaseException] = []
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            tree, step = item
            try:
                save(tree, self.directory, step)
                self._gc()
            except BaseException as e:  # surfaced on next save()/close()
                self._err.append(e)

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def save(self, tree: Any, step: int):
        if self._err:
            raise self._err.pop()
        # a host copy NOW: the train step overwrites the device tensors.
        # Parity leaves are dropped by save(), so they are not copied.
        host = [None if name.endswith("/cdc") else
                x.detach().to("cpu", copy=True)
                if isinstance(x, torch.Tensor) else np.array(x)
                for name, x in named_leaves(tree)]
        self._q.put((unflatten(tree, host), step))

    def close(self):
        self._q.put(_SENTINEL)
        self._t.join(timeout=300)
        if self._err:
            raise self._err.pop()
