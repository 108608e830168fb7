"""Training loop with fault tolerance: auto-resume, async checkpoints,
preemption handling, training over a mesh of ranks.

The loop is deliberately boring, as the reference's is: the failure
behaviour lives in the substrate — deterministic (seed, step) data
streams, atomic checkpoint directories, the offline parity re-encode on
every resume. A SIGTERM (preemption notice) triggers a final synchronous
save and stops, the fleet analogue of the paper's "the system never loses
a request". The step runs eagerly on ``TrainerConfig.device`` (the CUDA
card by default) and updates the params and optimizer state in place.

``Trainer(..., mesh=)``: a rank of a world (``dist.spawn_world``) over a
``dist.Mesh``. Between steps each rank keeps only its blocks of the params
and of the optimizer's mu, nu and master copy, under
``dist.param_specs(params, mesh)`` (FSDP over ``data``, TP over
``model``: the reference's ``param_shardings`` default); the step count is
replicated. A step gathers the params whole (one all-gather a leaf), runs
the forward and backward on this rank's block of the global batch over the
batch axes (pod and data), averages the loss and the gradients over the
batch line (all-reduce), clips by the whole averaged gradient's norm,
updates its own blocks, and drops the whole params. The model axis shards
what the ranks keep, not the compute: every rank of a model line runs the
same forward. So the numbers are the reference's, whose mesh step is
``jax.jit`` of the same function over sharded arrays: the same loss and
update, up to the order of the float sums. A tensor-parallel training
forward is not ported. Every message goes through ``dist.comm``;
``mesh_step_messages`` reckons a step's messages from the leaves' sizes
(the dry run's collective record, and the bytes ``comm.COUNTS`` gains).
"""
from __future__ import annotations

import dataclasses
import math
import os
import signal
import tempfile
import time
from typing import Any

import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.ckpt import (AsyncCheckpointer, gather_tree, latest_step,
                              restore)
from repro_torch.ckpt import save as sync_save
from repro_torch.data import DataConfig, make_stream
from repro_torch.device import resolve_device
from repro_torch.dist import comm
from repro_torch.dist.collectives import batch_block
from repro_torch.dist.sharding import (batch_axes, block_index,
                                       gather_params, local_shard,
                                       paired_leaves, param_specs)
from repro_torch.models.zoo import Model
from repro_torch.optim import AdamWConfig, adamw, init_state
from repro_torch.train.train_step import (TrainConfig, make_grad_fn,
                                          make_train_step)
from repro_torch.tree import named_leaves, tree_map


LOSS_BYTES = 4                   # the loss: a 0-d float32 (``lm_loss``)


def mesh_step_messages(params, mesh, specs=None, read=None
                       ) -> list[tuple[str, int, int]]:
    """The messages one rank sends in a step of ``Trainer(mesh=)``, as
    (kind, bytes of the result, group size): one all-gather over the whole
    world for each sharded leaf (``gather_params``: [world, *block]), one
    all-reduce over the batch line for each leaf whose gradient the loss
    reads (``read(name)``; every leaf when None), and one for the float32
    loss. ``params`` are the whole leaves (meta tensors will do); ``specs``
    default to ``param_specs(params, mesh)``. A line of one rank sends
    nothing (``dist.comm``). Outside the step, ``run`` adds one 4-byte
    all-reduce over the world a step (the ranks agreeing on SIGTERM)."""
    specs = param_specs(params, mesh) if specs is None else specs
    world = mesh.size
    line = math.prod(mesh.shape[a] for a in batch_axes(mesh))
    gathers, reduces = [], []
    for (name, leaf), (_, spec) in zip(named_leaves(params),
                                       paired_leaves(params, specs)):
        nb = leaf.numel() * leaf.element_size()
        if world > 1 and any(a is not None for a in spec):
            parts = math.prod(p for _, p in block_index(spec, mesh, 0))
            gathers.append(("all-gather", world * (nb // parts), world))
        if line > 1 and (read is None or read(name)):
            reduces.append(("all-reduce", nb, line))
    if line > 1:
        reduces.append(("all-reduce", LOSS_BYTES, line))
    return gathers + reduces


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    dtype: Any = torch.float32
    device: str = "cuda"


class Trainer:
    def __init__(self, model: Model, tcfg: TrainerConfig,
                 ocfg: AdamWConfig, scfg: TrainConfig, dcfg: DataConfig,
                 mesh=None):
        self.model = model
        self.tcfg, self.ocfg, self.scfg, self.dcfg = tcfg, ocfg, scfg, dcfg
        self.mesh = mesh
        self.device = resolve_device(tcfg.device)
        self._preempted = False
        self.specs = None          # the param spec tree, on a mesh
        if mesh is None:
            self.step_fn = make_train_step(model, ocfg, scfg)
        else:
            self._grad_fn = make_grad_fn(model, scfg)
            self.step_fn = self._mesh_step

    # ------------------------------------------------------------ state ----
    def init_state(self):
        """Params from ``seed`` (``Model.init``), their parity encoded
        offline (kernel 4 on the card), and a fresh optimizer state; on a
        mesh, this rank's blocks of both."""
        params = self.model.init(self.tcfg.seed, self.tcfg.dtype,
                                 device=self.device)
        with torch.no_grad():
            params = self.model.encode_offline(params)
        if self.mesh is not None:
            params = self._own_blocks(params)
        return params, init_state(params)

    def _own_blocks(self, params):
        """This rank's blocks of the whole ``params`` (copies, so the whole
        tensors can go), and the spec tree they were cut by."""
        rank = dist.get_rank()
        self.specs = param_specs(params, self.mesh)

        def cut(leaf, spec):
            if all(a is None for a in spec):
                return leaf
            return local_shard(leaf, spec, self.mesh, rank).clone()
        return tree_map(cut, params, self.specs)

    def _tree_specs(self):
        """Spec tree of the {"params", "opt"} checkpoint tree: mu, nu and
        master under the params' specs, the step replicated."""
        return {"params": self.specs,
                "opt": {"step": (), "mu": self.specs, "nu": self.specs,
                        "master": self.specs}}

    def maybe_resume(self, params, opt_state):
        """The latest checkpoint restored into (params, opt_state), the
        params' parity re-encoded; leaves the checkpoint drops (every
        ``/cdc`` path, the optimizer's too) keep the given tensors. On a
        mesh each rank reads its blocks, and the parity is encoded from
        the whole weight, then cut."""
        step = latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return params, opt_state, 0
        if self.mesh is None:
            tree = restore({"params": params, "opt": opt_state},
                           self.tcfg.ckpt_dir, step, device=self.device)
            with torch.no_grad():
                tree["params"] = self.model.encode_offline(tree["params"])
            return tree["params"], tree["opt"], step
        specs = self._tree_specs()
        kw = dict(device=self.device, mesh=self.mesh)
        # the params with their parity re-encoded; the optimizer's parity
        # paths keep the template's, as the single-process resume does
        p = restore({"params": params}, self.tcfg.ckpt_dir, step,
                    encode_ctx=self.model.ctx,
                    shardings={"params": specs["params"]}, **kw)
        o = restore({"opt": opt_state}, self.tcfg.ckpt_dir, step,
                    shardings={"opt": specs["opt"]}, **kw)
        return p["params"], o["opt"], step

    # ------------------------------------------------------- mesh step ----
    def _mesh_step(self, params, opt_state, batch, valid=None):
        """One step of a rank on the mesh: (its param blocks, its optimizer
        blocks, the global batch) -> the same, updated in place, and the
        metrics {"grad_norm", "lr", "loss"} of the whole batch."""
        mesh, rank = self.mesh, dist.get_rank()
        axes = batch_axes(mesh)
        line = mesh.group(axes)
        with record_function("train.gather"):
            whole = gather_params(params, mesh, self.specs)
        block = {k: batch_block(torch.as_tensor(v), mesh, axes, rank)[0]
                 for k, v in batch.items()}
        loss, grads = self._grad_fn(whole, block, valid)
        del whole
        with record_function("train.all_reduce"):
            n = line.size
            loss = comm.all_reduce(loss, line) / n
            grads = tree_map(lambda g: None if g is None else
                             comm.all_reduce(g, line).div_(n), grads)
        with record_function("train.optimizer"):
            gnorm = adamw.global_norm(grads)
            mine = tree_map(lambda g, s: None if g is None else
                            local_shard(g, s, mesh, rank), grads, self.specs)
            params, opt_state, metrics = adamw.apply_updates(
                self.ocfg, params, mine, opt_state, gnorm=gnorm)
        return params, opt_state, dict(metrics, loss=loss)

    def _agree_preempted(self) -> bool:
        """Whether any rank was sent SIGTERM (every rank asks at the same
        step, so all stop together); this process's flag alone off a
        mesh."""
        if self.mesh is None:
            return self._preempted
        flag = torch.tensor([1.0 if self._preempted else 0.0])
        return bool(comm.all_reduce(flag, comm.world_line()) > 0)

    def _whole_params(self, params):
        if self.mesh is None:
            return params
        return gather_params(params, self.mesh, self.specs)

    # ------------------------------------------------------------- loop ----
    def run(self, resume: bool = True) -> dict:
        """Train to ``steps`` (from the latest checkpoint when ``resume``).
        Returns {"losses": [(step, loss)], "wall_s", "final_step",
        "params"}: on a mesh the params are gathered whole on every
        rank."""
        params, opt_state = self.init_state()
        start = 0
        if resume:
            params, opt_state, start = self.maybe_resume(params, opt_state)
        writer = self._is_writer()
        ckpt = AsyncCheckpointer(self.tcfg.ckpt_dir) if writer else None
        old = signal.signal(signal.SIGTERM, self._on_sigterm)

        stream = make_stream(self.dcfg, start_step=start)
        losses = []
        t0 = time.time()
        try:
            for step in range(start, self.tcfg.steps):
                batch = {k: torch.as_tensor(v, device=self.device)
                         for k, v in next(stream).items()}
                params, opt_state, metrics = self.step_fn(params, opt_state,
                                                          batch)
                if (step + 1) % self.tcfg.log_every == 0 or \
                        step == self.tcfg.steps - 1:
                    loss = float(metrics["loss"])
                    losses.append((step + 1, loss))
                tree = {"params": params, "opt": opt_state}
                if (step + 1) % self.tcfg.ckpt_every == 0:
                    self._save_async(ckpt, tree, step + 1)
                if self._agree_preempted():
                    # final synchronous save, then bail (restartable)
                    if self.mesh is None:
                        sync_save(tree, self.tcfg.ckpt_dir, step + 1)
                    else:
                        sync_save(tree, self.tcfg.ckpt_dir, step + 1,
                                  mesh=self.mesh, specs=self._tree_specs())
                    break
        finally:
            if ckpt is not None:
                ckpt.close()
            signal.signal(signal.SIGTERM, old)
        if self.mesh is not None:
                # rank 0's writes are in place before any rank reads them
            comm.barrier(comm.world_line())
        wall = time.time() - t0
        return {"losses": losses, "wall_s": wall,
                "final_step": losses[-1][0] if losses else start,
                "params": self._whole_params(params)}

    def _is_writer(self) -> bool:
        """Whether this process writes the checkpoints: rank 0 on a mesh."""
        if self.mesh is None:
            return True
        return dist.get_rank() == 0

    def _save_async(self, ckpt, tree, step: int) -> None:
        """Hand the tree to the background writer. On a mesh every rank
        gathers its blocks to rank 0 here, on the training thread at the
        same step (the writer thread sends no message), and rank 0's whole
        host copy goes to its writer."""
        if self.mesh is not None:
            tree = gather_tree(tree, self.mesh, self._tree_specs())
        if ckpt is not None:
            ckpt.save(tree, step)

    def _on_sigterm(self, *_):
        self._preempted = True
