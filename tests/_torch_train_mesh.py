"""Rank programs of tests/test_torch_train_mesh.py.

Each runs in a process of a ``repro_torch.dist.spawn_world`` world, so this
module imports torch and repro_torch only (never jax: a spawned rank must
not load it). A rank returns numpy arrays and plain Python values.
"""
import os
import signal

from repro_torch.configs import get_arch, smoke_config
from repro_torch.data import DataConfig
from repro_torch.dist import Mesh, comm
from repro_torch.models import TPCtx, build
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig, TrainConfig
from repro_torch.tree import named_leaves

ARCH = "granite-3-8b"
T, R = 4, 2
SEQ, BATCH = 16, 4


def make_trainer(ckpt_dir: str, steps: int, ckpt_every: int, opt: dict, *,
                 microbatches: int = 1, mesh=None, device: str = "cpu"
                 ) -> Trainer:
    """Smoke granite, coded at T = 4, r = 2 folded, on the synthetic
    stream: the same trainer on a mesh (``mesh``) or in one process."""
    cfg = smoke_config(get_arch(ARCH))
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R))
    return Trainer(
        model, TrainerConfig(steps=steps, ckpt_dir=ckpt_dir,
                             ckpt_every=ckpt_every, log_every=1,
                             device=device),
        AdamWConfig(**opt), TrainConfig(microbatches=microbatches,
                                        remat="full"),
        DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH),
        mesh=mesh)


def _shapes(tree) -> dict:
    return {n: tuple(x.shape) for n, x in named_leaves(tree)}


def record(trainer: Trainer, valid=None, sigterm_at: int = 0) -> dict:
    """Wrap the trainer's step: before and after each step the shapes of
    the params and optimizer state it is handed, the step's ``comm``
    counts and its grad norm; ``valid`` passed to every step; SIGTERM sent
    to this process during step ``sigterm_at``."""
    log = {"held": [], "counts": [], "grad_norms": []}
    step_fn = trainer.step_fn

    def step(params, opt_state, batch):
        log["held"].append(_shapes({"params": params, "opt": opt_state}))
        if len(log["counts"]) + 1 == sigterm_at:
            os.kill(os.getpid(), signal.SIGTERM)
        comm.reset()
        out = step_fn(params, opt_state, batch, valid)
        log["counts"].append(dict(comm.COUNTS))
        log["grad_norms"].append(float(out[2]["grad_norm"]))
        log["held"].append(_shapes({"params": out[0], "opt": out[1]}))
        return out

    trainer.step_fn = step
    return log


def _np_tree(tree) -> dict:
    return {n: x.detach().cpu().numpy() for n, x in named_leaves(tree)}


def world_main(rank: int, n: int, case: dict) -> dict:
    """Every run of the test's 4-rank world, in one order on every rank:
    on (data 2, model 2) three steps fault-free (checkpoint at step 2),
    with 2 microbatches, and with shard 2 dead; then a resume from the
    step-2 checkpoint on a second mesh, (data 4, model 1); then a run in
    which only rank 1 is sent SIGTERM."""
    mesh = Mesh((2, 2), ("data", "model"))
    opt = case["opt"]
    out = {}
    runs = {"base": dict(dir=case["dir"], every=2),
            "mb2": dict(dir=case["dir"] + "_mb2", every=100, mb=2),
            "dead": dict(dir=case["dir"] + "_dead", every=100,
                         valid=case["dead"])}
    for key, r in runs.items():
        tr = make_trainer(r["dir"], 3, r["every"], opt,
                          microbatches=r.get("mb", 1), mesh=mesh)
        log = record(tr, r.get("valid"))
        res = tr.run(resume=False)
        log["losses"] = res["losses"]
        if key == "base" or rank == 0:
            log["params"] = _np_tree(res["params"])
        out[key] = log
    tr = make_trainer(case["dir"], 3, 100, opt,
                      mesh=Mesh((4, 1), ("data", "model")))
    log = record(tr)
    res = tr.run(resume=True)
    out["resumed"] = dict(log, losses=res["losses"])
    tr = make_trainer(case["dir"] + "_sig", 10, 100, opt, mesh=mesh)
    record(tr, sigterm_at=2 if rank == 1 else 0)
    out["sigterm"] = tr.run(resume=False)["final_step"]
    return out
