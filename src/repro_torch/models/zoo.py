"""Uniform model API (decoder-only families so far).

Model(cfg, ctx) exposes init / encode_offline / forward / init_decode /
decode with the reference's signatures, plus an explicit device. ``init``
defaults to the CUDA device and raises without one; pass device="cpu" to
run there.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.common import TPCtx, encode_tree

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    ctx: TPCtx

    def init(self, gen: torch.Generator | int = 0, dtype=torch.float32,
             device: str | torch.device = "cuda") -> Params:
        """Random parameters; ``gen`` is a torch.Generator on ``device`` or
        an integer seed for one."""
        if self.cfg.is_encdec:
            raise NotImplementedError("enc-dec models are not ported yet")
        dev = resolve_device(device)
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(gen))
        return transformer.init_params(self.cfg, gen, self.ctx, dtype, dev)

    def encode_offline(self, params: Params) -> Params:
        """The paper's offline CDC weight encode (rerun after weight load)."""
        return encode_tree(params, self.ctx)

    def forward(self, params: Params, batch: dict, valid=None, *,
                q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
        """batch {"tokens": [B, S]} -> logits [B, S, vocab] (float32)."""
        if self.cfg.is_encdec:
            raise NotImplementedError("enc-dec models are not ported yet")
        return transformer.forward(self.cfg, params, self.ctx,
                                   torch.as_tensor(
                                       batch["tokens"],
                                       device=params["embed"].device),
                                   valid, q_chunk=q_chunk,
                                   kv_chunk=kv_chunk)

    def init_decode(self, params: Params, b: int, max_len: int,
                    dtype=torch.float32) -> Params:
        return transformer.init_decode_state(
            self.cfg, self.ctx, b, max_len, dtype,
            device=params["embed"].device)

    def decode(self, params: Params, state: Params, tokens: torch.Tensor,
               valid=None, *, kv_chunk: int = 1024, last_only: bool = False,
               return_hidden: bool = False):
        return transformer.decode_step(self.cfg, params, self.ctx, state,
                                       tokens, valid, kv_chunk=kv_chunk,
                                       last_only=last_only,
                                       return_hidden=return_hidden)


def build(cfg, ctx: TPCtx | None = None) -> Model:
    return Model(cfg, ctx or TPCtx())
