"""Loss + train step with gradient-accumulation microbatching.

The train step maps (params, opt_state, batch) -> (params, opt_state,
metrics) as the reference's does, but updates the param and optimizer
tensors in place (the reference's jitted step donates them). Gradients
come from autograd over the model's forward, which checkpoints each layer
as ``TrainConfig.remat`` says; on the card every norm runs kernel 6 and
its backward kernel (``kernels.rmsnorm.RMSNormGrad``). Microbatches split
the batch along its first axis; their gradients add in float32 and their
losses average. CDC note: the coded forward (and its parity GEMMs)
differentiates, so a step with an erasure mask trains THROUGH the failure:
the gradients of erased shards flow through the recovery combine.

The step's phases run in ``torch.profiler.record_function`` ranges
("train.forward" around "train.loss", "train.backward",
"train.optimizer"), so a profile can split a step's device time; with no
profiler running a range costs about a microsecond.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from repro_torch.optim import adamw
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The train step's settings, the reference's fields. ``aux_loss_weight``
    is taken and read nowhere, as in the reference."""

    microbatches: int = 1          # grad-accum steps per train step
    remat: str = "full"
    # the reference's MoE load-balance weight. Its loss adds nothing for it
    # (the aux loss is plumbed nowhere, src/repro/train/train_step.py), so
    # neither does this one: a real aux term would part the two losses
    aux_loss_weight: float = 0.01
    q_chunk: int = 512
    kv_chunk: int = 1024


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
            vocab: int) -> torch.Tensor:
    """Next-token cross entropy in float32. logits: [B, S, V]; tokens:
    [B, S]."""
    targets = tokens[:, 1:].long()
    lg = logits[:, :-1].to(torch.float32)
    logz = torch.logsumexp(lg, dim=-1)
    tgt_logit = torch.gather(lg, -1, targets[..., None])[..., 0]
    return (logz - tgt_logit).mean()


def make_loss_fn(model, tcfg: TrainConfig):
    def loss_fn(params, batch, valid=None):
        logits = model.forward(params, batch, valid, remat=tcfg.remat,
                               q_chunk=tcfg.q_chunk, kv_chunk=tcfg.kv_chunk)
        tokens = torch.as_tensor(batch["tokens"], device=logits.device)
        with record_function("train.loss"):
            return lm_loss(logits, tokens, model.cfg.vocab)
    return loss_fn


def _split(batch: dict, n_mb: int) -> list[dict]:
    """The batch cut along its first axis into ``n_mb`` equal
    microbatches."""
    size = next(iter(batch.values())).shape[0]
    if size % n_mb:
        raise ValueError(f"batch of {size} does not split into {n_mb} "
                         f"microbatches")
    b = size // n_mb
    return [{k: v[i * b:(i + 1) * b] for k, v in batch.items()}
            for i in range(n_mb)]


def value_and_grad(loss_fn, params, batch, valid=None):
    """(loss, grads) of ``loss_fn(params, batch, valid)`` by autograd, as
    ``jax.value_and_grad`` gives them: grads has the params' structure,
    with None where the loss did not read the param (zeros to the
    optimizer). The params do not require grad before or after."""
    ps = leaves(params)
    for p in ps:
        p.grad = None
        p.requires_grad_(True)
    try:
        with record_function("train.forward"):
            loss = loss_fn(params, batch, valid)
        with record_function("train.backward"):
            loss.backward()
        return loss.detach(), tree_map(lambda p: p.grad, params)
    finally:
        for p in ps:
            p.requires_grad_(False)
            p.grad = None


def make_grad_fn(model, tcfg: TrainConfig):
    """Returns grad_fn(params, batch, valid=None) -> (loss, grads): over
    ``tcfg.microbatches`` microbatches, the mean loss and the mean of their
    gradients, added in float32."""
    loss_fn = make_loss_fn(model, tcfg)

    def grad_fn(params, batch, valid=None):
        n_mb = tcfg.microbatches
        if n_mb == 1:
            return value_and_grad(loss_fn, params, batch, valid)
        acc, lsum = None, 0.0
        for mbatch in _split(batch, n_mb):
            loss, g = value_and_grad(loss_fn, params, mbatch, valid)
            g = tree_map(
                lambda x: None if x is None else x.to(torch.float32), g)
            acc = g if acc is None else tree_map(
                lambda a, x: a if x is None else
                (x if a is None else a.add_(x)), acc, g)
            lsum = lsum + loss
        return lsum / n_mb, tree_map(
            lambda a: None if a is None else a.div_(n_mb), acc)

    return grad_fn


def make_train_step(model, ocfg: adamw.AdamWConfig, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, batch, valid=None) ->
    (params, opt_state, metrics) with metrics {"grad_norm", "lr", "loss"}
    (0-d float32 tensors on the params' device)."""
    grad_fn = make_grad_fn(model, tcfg)

    def train_step(params, opt_state, batch, valid=None):
        loss, grads = grad_fn(params, batch, valid)
        with record_function("train.optimizer"):
            params, opt_state, metrics = adamw.apply_updates(
                ocfg, params, grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step
