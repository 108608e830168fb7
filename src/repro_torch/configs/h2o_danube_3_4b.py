"""h2o-danube-3-4b [dense] — llama+mistral mix, SWA. [arXiv:2401.16818; unverified]"""
from repro_torch.configs.base import ArchConfig, register

H2O_DANUBE_3_4B = register(ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000,
    attn_kind="swa", window=4096,
))
