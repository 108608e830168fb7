"""Architecture registry of the PyTorch port.

A copy of the reference package's ``configs/base.py`` (the dataclass, the
registry, ``smoke_config``, the parameter counts, the shape registry and
``runnable``), kept here so that the port imports nothing
of the reference. Every architecture of the reference is registered:
the dense decoders (granite-3-8b, h2o-danube-1.8b and -3-4b, deepseek-67b),
chameleon-34b, which the reference builds as a dense decoder, the
encoder-decoder whisper-medium, the recurrent xlstm-125m (mLSTM and
sLSTM blocks), the hybrid hymba-1.5b (attention and a mamba branch in
every layer) and the mixtures of experts qwen2-moe-a2.7b (60 routed
experts, top-4, beside 4 shared ones) and qwen3-moe-235b-a22b (128
routed experts, top-8, no shared one).

The port also registers one architecture the reference does not have
(``PORT_ONLY``): nemotron-h-47b, a ``PatternConfig`` whose layers differ
in kind (Mamba-2, attention, MLP). Its own fields live on the subclass,
so the ten configs shared with the reference keep exactly the
reference's fields.
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

    @property
    def param_count(self) -> int:
        """Approximate parameter count, the reference's formula (for a
        model-FLOPs estimate)."""
        d, hd = self.d_model, self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        if self.ssm_kind == "xlstm":
            per_layer = 2 * d * 2 * d + 3 * (2 * d) * (2 * d) // 4  # rough
        else:
            ffn = 3 * d * self.d_ff if self.act == "silu" \
                else 2 * d * self.d_ff
            if self.n_experts:
                ffe = 3 * d * self.d_ff_expert
                ffn = self.n_experts * ffe + self.n_shared_experts * ffe \
                    + d * self.n_experts
            per_layer = attn + ffn
            if self.ssm_kind == "mamba":
                per_layer += 2 * d * 2 * d + 2 * d * self.ssm_state * 2
        total = self.n_layers * per_layer
        if self.is_encdec:
            total += self.encoder_layers * per_layer + \
                self.n_layers * attn  # cross-attention
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        return total

    @property
    def active_param_count(self) -> int:
        """Active params per token (MoE: only the routed top_k and the
        shared experts)."""
        if not self.n_experts:
            return self.param_count
        ffe = 3 * self.d_model * self.d_ff_expert
        inactive = (self.n_experts - self.top_k) * ffe * self.n_layers
        return self.param_count - inactive


#: the layer kinds of a ``PatternConfig``'s pattern
MAMBA2, ATTENTION, MLP = "M", "*", "-"


@dataclasses.dataclass(frozen=True)
class PatternConfig(ArchConfig):
    """A decoder whose layers differ in kind: one mixer a layer, each
    ``x + mixer(rmsnorm(x))``, in a published pattern (Nemotron-H's
    ``hybrid_override_pattern``): ``M`` a Mamba-2 layer (arXiv:2405.21060),
    ``*`` attention (GQA, no position encoding), ``-`` an ungated MLP
    (``act``). A stack of ``n_layers`` takes the pattern's first
    ``n_layers`` characters, so a depth cut keeps the published order.
    ``ssm_state`` is the Mamba-2 state size N."""
    pattern: str = ""
    mamba_heads: int = 0           # H
    mamba_head_dim: int = 0        # P
    mamba_groups: int = 0          # G: B and C are shared by H / G heads
    mamba_chunk: int = 128         # the prefill's SSD chunk
    conv_kernel: int = 4

    @property
    def rope(self) -> bool:
        """The attention layers rotate nothing (NoPE)."""
        return False

    @property
    def layer_kinds(self) -> str:
        if not 0 < self.n_layers <= len(self.pattern):
            raise ValueError(f"{self.name}: {self.n_layers} layers of a "
                             f"{len(self.pattern)}-layer pattern")
        return self.pattern[:self.n_layers]

    @property
    def mamba_inner(self) -> int:
        return self.mamba_heads * self.mamba_head_dim

    @property
    def mamba_conv_dim(self) -> int:
        """The conv's channels: x, B and C."""
        return self.mamba_inner + 2 * self.mamba_groups * self.ssm_state

    @property
    def param_count(self) -> int:
        d, hd = self.d_model, self.hd
        di, cd = self.mamba_inner, self.mamba_conv_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        mamba = d * (di + cd + self.mamba_heads) \
            + cd * (self.conv_kernel + 1) + 3 * self.mamba_heads + di + di * d
        per = {MAMBA2: mamba, ATTENTION: attn, MLP: 2 * d * self.d_ff}
        return sum(per[k] for k in self.layer_kinds) \
            + self.vocab * d * (1 if self.tie_embeddings else 2)

    def smoke(self) -> "PatternConfig":
        """The CPU smoke size of the stack: one layer of each kind, small
        Mamba-2 widths, chunks of 16 (``smoke_config`` calls it)."""
        return dataclasses.replace(
            self, n_layers=3, pattern=MAMBA2 + ATTENTION + MLP,
            mamba_heads=8, mamba_head_dim=16, mamba_groups=2, ssm_state=16,
            mamba_chunk=16)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, ArchConfig] = {}
#: the registered names the reference package does not have
PORT_ONLY = frozenset({"nemotron-h-47b"})


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
                                     hymba_1_5b, nemotron_h_47b,
                                     qwen2_moe_a2_7b,
                                     qwen3_moe_235b_a22b, whisper_medium,
                                     xlstm_125m)


def runnable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Is (arch x shape) a real cell or a structured skip?"""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: no sub-quadratic path for "
                       "524k decode (DESIGN.md §6)")
    return True, ""


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests (same reduction as
    the reference's ``smoke_config``; a ``PatternConfig`` then takes its
    own ``smoke``)."""
    smoke = dataclasses.replace(
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
    return smoke.smoke() if isinstance(smoke, PatternConfig) else smoke
