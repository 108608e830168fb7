"""hymba-1.5b [hybrid] — parallel attention + mamba heads per block.
[arXiv:2411.13676; hf]"""
from repro_torch.configs.base import ArchConfig, register

HYMBA_1_5B = register(ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001,
    ssm_kind="mamba", ssm_state=16,
    attn_kind="swa", window=1024,  # hymba uses SWA for most layers
))
