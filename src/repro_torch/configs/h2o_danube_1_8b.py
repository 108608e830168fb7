"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]"""
from repro_torch.configs.base import ArchConfig, register

H2O_DANUBE_1_8B = register(ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32000,
    attn_kind="swa", window=4096,
))
