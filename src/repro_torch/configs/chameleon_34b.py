"""chameleon-34b [vlm] — early-fusion VQ image tokens; the image tokenizer is
a STUB (token ids in the shared 65536 vocab). [arXiv:2405.09818; unverified]
The body is a dense decoder, as the reference builds it."""
from repro_torch.configs.base import ArchConfig, register

CHAMELEON_34B = register(ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65536,
))
