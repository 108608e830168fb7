"""nemotron-h-47b [hybrid] — Mamba-2, attention and MLP layers in a
published 98-layer pattern: 45 Mamba-2 (256 heads of 64, state 256, 8
groups, conv 4), 48 ungated relu² MLPs of width 30720, 5 GQA attention
layers (64/8 heads of 128, no rotary). Not in the reference package
(``base.PORT_ONLY``). [hf:nvidia/Nemotron-H-47B-Base-8K config.json;
arXiv:2504.03624]"""
from repro_torch.configs.base import PatternConfig, register

NEMOTRON_H_47B = register(PatternConfig(
    name="nemotron-h-47b", family="hybrid",
    n_layers=98, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=30720, vocab=131072, act="relu2", norm_eps=1e-5,
    ssm_kind="mamba2", ssm_state=256,
    pattern="M-M-M-M-M-M-M-M-M*-M-M-M-M-M-M-M-M-M-M*-M-M-M-M-M*-M-M-M-M-M*-"
            "M-M-M-M-M-M-M---MM---M-M*-M-M-M-M-M-",
    mamba_heads=256, mamba_head_dim=64, mamba_groups=8, mamba_chunk=128,
    conv_kernel=4,
))
