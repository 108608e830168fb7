"""Training loop with fault tolerance: auto-resume, async checkpoints,
preemption handling.

The loop is deliberately boring, as the reference's is: the failure
behaviour lives in the substrate — deterministic (seed, step) data
streams, atomic checkpoint directories, the offline parity re-encode on
every resume. A SIGTERM (preemption notice) triggers a final synchronous
save and stops, the fleet analogue of the paper's "the system never loses
a request". The step runs eagerly on ``TrainerConfig.device`` (the CUDA
card by default) and updates the params and optimizer state in place.
The trainer holds whole params on one device: the reference's mesh path
(``Trainer(mesh=...)``, FSDP-sharded params and optimizer state) is not
ported; ``repro_torch.dist`` has the layout rules and the elastic
checkpoint it would use.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any

import torch

from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore
from repro_torch.ckpt import save as sync_save
from repro_torch.data import DataConfig, make_stream
from repro_torch.device import resolve_device
from repro_torch.models.zoo import Model
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.train.train_step import TrainConfig, make_train_step


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
                 ocfg: AdamWConfig, scfg: TrainConfig, dcfg: DataConfig):
        self.model = model
        self.tcfg, self.ocfg, self.scfg, self.dcfg = tcfg, ocfg, scfg, dcfg
        self.device = resolve_device(tcfg.device)
        self._preempted = False
        self.step_fn = make_train_step(model, ocfg, scfg)

    # ------------------------------------------------------------ state ----
    def init_state(self):
        """Params from ``seed`` (``Model.init``), their parity encoded
        offline (kernel 4 on the card), and a fresh optimizer state."""
        params = self.model.init(self.tcfg.seed, self.tcfg.dtype,
                                 device=self.device)
        with torch.no_grad():
            params = self.model.encode_offline(params)
        return params, init_state(params)

    def maybe_resume(self, params, opt_state):
        """The latest checkpoint restored into (params, opt_state), the
        params' parity re-encoded; leaves the checkpoint drops (every
        ``/cdc`` path, the optimizer's too) keep the given tensors."""
        step = latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return params, opt_state, 0
        tree = restore({"params": params, "opt": opt_state},
                       self.tcfg.ckpt_dir, step, device=self.device)
        with torch.no_grad():
            tree["params"] = self.model.encode_offline(tree["params"])
        return tree["params"], tree["opt"], step

    # ------------------------------------------------------------- loop ----
    def run(self, resume: bool = True) -> dict:
        params, opt_state = self.init_state()
        start = 0
        if resume:
            params, opt_state, start = self.maybe_resume(params, opt_state)
        ckpt = AsyncCheckpointer(self.tcfg.ckpt_dir)
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
                if (step + 1) % self.tcfg.ckpt_every == 0:
                    ckpt.save({"params": params, "opt": opt_state}, step + 1)
                if self._preempted:
                    # final synchronous save, then bail (restartable)
                    sync_save({"params": params, "opt": opt_state},
                              self.tcfg.ckpt_dir, step + 1)
                    break
        finally:
            ckpt.close()
            signal.signal(signal.SIGTERM, old)
        wall = time.time() - t0
        return {"losses": losses, "wall_s": wall,
                "final_step": losses[-1][0] if losses else start,
                "params": params}

    def _on_sigterm(self, *_):
        self._preempted = True
