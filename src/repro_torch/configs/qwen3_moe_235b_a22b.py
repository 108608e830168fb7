"""qwen3-moe-235b-a22b [moe] — 128 routed experts, top-8, GQA kv=4.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ArchConfig, register

QWEN3_MOE_235B_A22B = register(ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936,
    n_experts=128, top_k=8, n_shared_experts=0, d_ff_expert=1536,
))
