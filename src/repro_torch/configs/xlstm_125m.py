"""xlstm-125m [ssm] — sLSTM + mLSTM blocks (xLSTM[7:1]), d_ff=0 (block-internal
projections). [arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ArchConfig, register

XLSTM_125M = register(ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    ssm_kind="xlstm", ssm_state=0, slstm_every=8,  # blocks 7, ... are sLSTM
))
