"""Architecture registry of the PyTorch port.

A copy of the reference package's ``configs/base.py`` (the dataclass, the
registry and ``smoke_config``), kept here so that the port imports nothing
of the reference. Every architecture of the reference is registered:
the dense decoders (granite-3-8b, h2o-danube-1.8b and -3-4b, deepseek-67b),
chameleon-34b, which the reference builds as a dense decoder, the
encoder-decoder whisper-medium, the recurrent xlstm-125m (mLSTM and
sLSTM blocks), the hybrid hymba-1.5b (attention and a mamba branch in
every layer) and the mixtures of experts qwen2-moe-a2.7b (60 routed
experts, top-4, beside 4 shared ones) and qwen3-moe-235b-a22b (128
routed experts, top-8, no shared one).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 => d_model // n_heads
    # attention
    attn_kind: str = "full"      # full | swa
    window: int = 4096           # SWA window
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    # SSM / hybrid
    ssm_kind: str = ""           # "" | mamba | xlstm
    ssm_state: int = 0
    slstm_every: int = 0
    # encoder-decoder
    encoder_layers: int = 0
    enc_seq: int = 0
    # misc
    act: str = "silu"            # silu (gated) | gelu (ungated)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # CDC (the paper's technique; toggled per run)
    coded: bool = False
    code_r: int = 2
    code_layout: str = "folded"  # folded | dedicated

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context? (SWA window or SSM
        state.)"""
        return self.attn_kind == "swa" or bool(self.ssm_kind)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        load_all()
    return _REGISTRY[name]


def all_archs() -> dict[str, ArchConfig]:
    if not _REGISTRY:
        load_all()
    return dict(_REGISTRY)


def load_all() -> None:
    """Import every config module (they self-register)."""
    from repro_torch.configs import (chameleon_34b,  # noqa: F401
                                     deepseek_67b, granite_3_8b,
                                     h2o_danube_1_8b, h2o_danube_3_4b,
                                     hymba_1_5b, qwen2_moe_a2_7b,
                                     qwen3_moe_235b_a22b, whisper_medium,
                                     xlstm_125m)


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests (same reduction as
    the reference's ``smoke_config``)."""
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        window=min(cfg.window, 64),
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        enc_seq=min(cfg.enc_seq, 16) if cfg.enc_seq else 0,
        slstm_every=min(cfg.slstm_every, 2) if cfg.slstm_every else 0,
    )
