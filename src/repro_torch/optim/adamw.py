"""AdamW + LR schedules + global-norm clipping, as plain functions over the
param tree (no ``torch.optim``: its clipping, master copy and schedule are
not the reference's).

Mixed precision as in the reference: params may be bf16; the master copy
and the moments are float32. The step is a 0-d int32 tensor on the params'
device, and the schedule is computed from it in float32 on that device, so
a step never waits for the host. ``apply_updates`` writes the moments, the
master copy and the params in place (the reference's train step donates
them); it returns the same tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"  # cosine | constant


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), in
    float32: linear warmup, then cosine down to ``min_lr_ratio`` (or
    constant)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_state(params: Any) -> dict:
    """Zero moments and a float32 master copy that does not alias the
    params (the step updates both in place)."""
    device = leaves(params)[0].device
    with torch.no_grad():
        return {
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "mu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
            "nu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
            "master": tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params),
        }


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32; a None leaf (a
    gradient never computed) counts as zeros."""
    sq = [torch.sum(torch.square(g.to(torch.float32)))
          for g in leaves(tree) if g is not None]
    return torch.sqrt(torch.stack(sq).sum())


def _decay_mask(params: Any) -> Any:
    """No weight decay on 1-D params (norm gains, biases)."""
    return tree_map(lambda p: p.ndim >= 2, params)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Any, grads: Any, state: dict,
                  gnorm: torch.Tensor | None = None
                  ) -> tuple[Any, dict, dict]:
    """One AdamW step. ``grads`` has the params' structure; a None leaf is a
    zero gradient (the reference differentiates every leaf, and a leaf the
    loss never reads gets zeros: its moments still decay, and its master
    copy still takes weight decay). ``gnorm``: the norm to clip by, in
    place of ``global_norm(grads)`` (a rank that updates its blocks of the
    params clips by the whole gradient's norm). Returns (params,
    new_state, metrics), every tensor updated in place."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    if cfg.grad_clip:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf

    def upd(m, v, g, p, use_decay):
        if g is None:             # b1 * m + (1 - b1) * 0, exactly
            m.mul_(cfg.b1)
            v.mul_(cfg.b2)
        else:
            g = g.to(torch.float32) * scale
            m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        delta = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        if use_decay:
            delta.add_(p, alpha=cfg.weight_decay)
        p.sub_(delta.mul_(lr))

    for m, v, g, p, dk in zip(leaves(state["mu"]), leaves(state["nu"]),
                              leaves(grads), leaves(state["master"]),
                              leaves(_decay_mask(params))):
        upd(m, v, g, p, dk)
    for p, mp in zip(leaves(params), leaves(state["master"])):
        p.copy_(mp)
    state["step"].copy_(step)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, state, metrics
