"""Uniform model API over the ported families: dense decoders, the
mixtures of experts (qwen2-moe, qwen3-moe: their decode state is the KV
cache alone), the hybrid (hymba: attention + mamba), the encoder-decoder
(whisper) and xLSTM.

Model(cfg, ctx) exposes init / encode_offline / forward / init_decode /
decode with the reference's signatures, plus an explicit device.
``batch`` is a dict: {"tokens": [B, S]}, and whisper adds {"frames": [B,
enc_seq, D]} (the frontend stub). ``init`` defaults to the CUDA device
and raises without one; pass device="cpu" to run there. An xLSTM decode
state is a list of per-block recurrent states with the batch (slot) axis
leading, independent of ``max_len``; a hybrid's is the KV cache plus the
mamba branch's conv window and SSM state ({"kv": ..., "mamba": {"conv",
"ssm"}}, slots on axis 1); ``init_decode`` and ``empty_decode`` build
both as ``transformer.init_decode_state`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.common import TPCtx, encode_tree

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    ctx: TPCtx

    def init(self, gen: torch.Generator | int = 0, dtype=torch.float32,
             device: str | torch.device = "cuda") -> Params:
        """Random parameters; ``gen`` is a torch.Generator on ``device`` or
        an integer seed for one. On the meta device (shapes and dtypes, no
        storage: the dry run's) no generator is used."""
        dev = resolve_device(device)
        if dev.type == "meta":
            gen = None
        elif not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(gen))
        family = encdec if self.cfg.is_encdec else transformer
        return family.init_params(self.cfg, gen, self.ctx, dtype, dev)

    def encode_offline(self, params: Params) -> Params:
        """The paper's offline CDC weight encode (rerun after weight load)."""
        return encode_tree(params, self.ctx)

    @staticmethod
    def _frames(params: Params, batch: dict) -> torch.Tensor:
        """The batch's frames on the params' device: numpy frames in
        float32 (the reference's default precision), a tensor (the dry
        run's meta stand-in) in the params' dtype."""
        emb = params["embed"]
        if isinstance(batch["frames"], torch.Tensor):
            return batch["frames"].to(device=emb.device, dtype=emb.dtype)
        return torch.as_tensor(np.asarray(batch["frames"], np.float32),
                               device=emb.device)

    def forward(self, params: Params, batch: dict, valid=None, *,
                remat: str = "full", q_chunk: int = 512,
                kv_chunk: int = 1024) -> torch.Tensor:
        """batch -> logits [B, S, vocab] (float32), teacher-forced; under
        grad mode each layer is checkpointed by ``remat``."""
        tokens = torch.as_tensor(batch["tokens"],
                                 device=params["embed"].device)
        if self.cfg.is_encdec:
            return encdec.forward(self.cfg, params, self.ctx, tokens,
                                  self._frames(params, batch), valid,
                                  remat=remat, q_chunk=q_chunk,
                                  kv_chunk=kv_chunk)
        return transformer.forward(self.cfg, params, self.ctx, tokens, valid,
                                   remat=remat, q_chunk=q_chunk,
                                   kv_chunk=kv_chunk)

    def init_decode(self, params: Params, batch: dict, b: int, max_len: int,
                    dtype=torch.float32, valid=None) -> Params:
        """A fresh per-row decode state for ``b`` rows. The enc-dec runs
        its encoder over ``batch["frames"]`` under ``valid`` (its coded
        GEMMs see the current mask) to fill the cross-attention bank."""
        if self.cfg.is_encdec:
            return encdec.init_decode_state(
                self.cfg, self.ctx, params, self._frames(params, batch), b,
                max_len, dtype, valid)
        return transformer.init_decode_state(
            self.cfg, self.ctx, b, max_len, dtype,
            device=params["embed"].device)

    def empty_decode(self, b: int, max_len: int, dtype=torch.float32,
                     device: str | torch.device = "cuda") -> Params:
        """A decode state's tensors for ``b`` rows, allocated without
        running the model (no encoder)."""
        if self.cfg.is_encdec:
            return encdec.empty_decode_state(self.cfg, self.ctx, b, max_len,
                                             dtype, device)
        return transformer.init_decode_state(self.cfg, self.ctx, b, max_len,
                                             dtype, device=device)

    def decode(self, params: Params, state: Params, tokens: torch.Tensor,
               valid=None, *, kv_chunk: int = 1024, last_only: bool = False,
               return_hidden: bool = False):
        family = encdec if self.cfg.is_encdec else transformer
        return family.decode_step(self.cfg, params, self.ctx, state, tokens,
                                  valid, kv_chunk=kv_chunk,
                                  last_only=last_only,
                                  return_hidden=return_hidden)

    def input_spec(self, batch: int, seq: int, dtype=torch.bfloat16
                   ) -> dict:
        """Stand-ins for a batch, as the reference's ``input_spec`` gives
        them: meta tensors (shapes and dtypes, no storage) of int32 tokens
        [batch, seq] and, for the enc-dec, frames [batch, enc_seq, D] in
        ``dtype``."""
        spec = {"tokens": torch.empty((batch, seq), dtype=torch.int32,
                                      device="meta")}
        if self.cfg.is_encdec:
            spec["frames"] = torch.empty(
                (batch, self.cfg.enc_seq, self.cfg.d_model), dtype=dtype,
                device="meta")
        return spec

    def dummy_batch(self, rng: np.random.Generator, batch: int, seq: int
                    ) -> dict:
        """Random requests from a numpy generator: tokens [batch, seq],
        then (enc-dec) frames [batch, enc_seq, D] drawn after them."""
        out = {"tokens": rng.integers(0, self.cfg.vocab, (batch, seq))}
        if self.cfg.is_encdec:
            out["frames"] = rng.normal(
                size=(batch, self.cfg.enc_seq, self.cfg.d_model)
            ).astype(np.float32)
        return out


def build(cfg, ctx: TPCtx | None = None) -> Model:
    return Model(cfg, ctx or TPCtx())
