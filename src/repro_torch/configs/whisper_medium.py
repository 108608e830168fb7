"""whisper-medium [audio] — enc-dec; the conv/audio frontend is a stub: a
request carries precomputed 1500-frame embeddings. [arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig, register

WHISPER_MEDIUM = register(ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    encoder_layers=24, enc_seq=1500,
    act="gelu",
))
