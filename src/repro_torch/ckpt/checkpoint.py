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
    default)
  * elastic: ``save(..., mesh=, specs=)`` from a world of ranks (each
    holding its blocks, ``dist.shard_params``) gathers every leaf to rank
    0, which writes the global arrays; ``restore(..., mesh=, shardings=)``
    gives each rank only its own block of every leaf, read from a memory
    map, under any mesh's specs: a checkpoint saved from one mesh restores
    onto another, or onto one process (the paper's degraded
    redistribution, §6). Parity is re-encoded from the whole weight and
    then cut to the rank's block.
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


def save(tree: Any, directory: str, step: int, *, mesh=None,
         specs: Any = None) -> str:
    """Synchronous atomic save of a tree of tensors (or numpy arrays);
    parity leaves (path ending in ``/cdc``) are not written. With ``mesh``
    (and ``specs``, the spec tree ``tree``'s blocks were cut by), every rank
    of the world calls it with its own blocks: rank 0 gathers and writes
    the whole leaves, the others send theirs and wait until the checkpoint
    is in place."""
    if mesh is not None:
        return _save_from_world(tree, directory, step, mesh, specs)
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


def gather_tree(tree, mesh, specs) -> Any:
    """The whole leaves of a world's blocks on rank 0: ``tree`` holds this
    rank's blocks (cut under ``specs``); every rank calls it at the same
    point. Rank 0 gets ``tree``'s structure with each sharded leaf
    assembled on the host and each replicated leaf as its own tensor;
    parity leaves (``/cdc``, never written) are None, and so is every leaf
    on the other ranks. One gather a sharded leaf (``dist.comm``)."""
    import torch.distributed as dist
    from repro_torch.dist import comm
    from repro_torch.dist.sharding import assemble, paired_leaves
    world = comm.world_line()
    me = dist.get_rank()
    whole = []
    for (name, _), (blk, spec) in zip(named_leaves(tree),
                                      paired_leaves(tree, specs)):
        if name.endswith("/cdc"):
            whole.append(None)
            continue
        if all(a is None for a in spec):      # replicated: rank 0's own
            whole.append(blk if me == 0 else None)
            continue
        blocks = comm.gather(torch.as_tensor(blk), 0, world)
        whole.append(assemble(blocks, spec, mesh) if me == 0 else None)
    return unflatten(tree, whole)


def _save_from_world(tree, directory: str, step: int, mesh, specs) -> str:
    import torch.distributed as dist
    from repro_torch.dist import comm
    whole = gather_tree(tree, mesh, specs)
    path = os.path.join(directory, f"step_{step:08d}")
    if dist.get_rank() == 0:
        path = save(whole, directory, step)
    comm.barrier(comm.world_line())
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _load(path: str, entry: dict) -> torch.Tensor:
    return _to_tensor(np.load(os.path.join(path, entry["file"])), entry)


def _to_tensor(arr: np.ndarray, entry: dict) -> torch.Tensor:
    if entry["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != entry["dtype"]:
        arr = arr.astype(np.dtype(entry["dtype"]))
    return torch.from_numpy(arr)


def restore(template: Any, directory: str, step: int | None = None, *,
            device: str | torch.device | None = None,
            encode_ctx=None, mesh=None, shardings: Any = None) -> Any:
    """Restore into the structure of ``template`` (values replaced).

    A leaf the checkpoint lacks, or a parity leaf, keeps the template's
    tensor. device: where the loaded leaves go (each template leaf's
    device when None). encode_ctx: a TPCtx — recompute every parity leaf
    from its base weight after the load (under no_grad: the encode is an
    offline step, never differentiated). mesh, shardings: the elastic
    path (a rank of a world over ``mesh``): each leaf is this rank's block
    under its spec in ``shardings`` (a spec tree, ``dist.param_specs``),
    read from a memory map; the template's leaves only name the tree.
    """
    path, by_name = _manifest(directory, step)
    if mesh is not None:
        return _restore_blocks(template, path, by_name, device, encode_ctx,
                               mesh, shardings)
    out = []
    for name, tmpl in named_leaves(template):
        entry = by_name.get(name)
        if entry is None or entry["kind"] == "parity":
            out.append(tmpl)  # parity re-encoded below / missing kept
            continue
        out.append(_load(path, entry).to(_device(tmpl, device)))
    tree = unflatten(template, out)
    if encode_ctx is not None and encode_ctx.coded:
        from repro_torch.models.common import encode_tree
        with torch.no_grad():
            tree = encode_tree(tree, encode_ctx)
    return tree


def _manifest(directory: str, step: int | None) -> tuple[str, dict]:
    """The checkpoint directory of ``step`` (the latest when None) and its
    manifest's leaves by name."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        return path, {e["name"]: e for e in json.load(f)["leaves"]}


def _device(tmpl, device):
    """Where a restored leaf goes: ``device``, else the template leaf's."""
    if device is not None:
        return device
    return tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu"


def _restore_blocks(template, path: str, by_name: dict, device, encode_ctx,
                    mesh, shardings):
    import torch.distributed as dist
    from repro_torch.core.coded_layer import make_parity_weights
    from repro_torch.dist.sharding import local_shard, paired_leaves
    rank = dist.get_rank()
    recode = encode_ctx is not None and encode_ctx.coded
    out = []
    for (name, tmpl), (_, spec) in zip(named_leaves(template),
                                       paired_leaves(template, shardings)):
        entry = by_name.get(name)
        if name.endswith("/cdc") and recode:
            # the parity of the whole weight, then this rank's block
            w_name = name[:-len("cdc")] + "w"
            w = _load(path, by_name[w_name]).to(_device(tmpl, device))
            with torch.no_grad():
                cdc = make_parity_weights(w, encode_ctx.spec)
            out.append(local_shard(cdc, spec, mesh, rank).contiguous())
        elif entry is None or entry["kind"] == "parity":
            out.append(tmpl)
        else:   # this rank's block of the memory map, read and copied
            arr = np.load(os.path.join(path, entry["file"]), mmap_mode="r")
            blk = np.array(local_shard(arr, spec, mesh, rank))
            out.append(_to_tensor(blk, entry).to(_device(tmpl, device)))
    return unflatten(template, out)


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
