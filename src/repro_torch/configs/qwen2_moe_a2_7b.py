"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]. 60 experts pad to 64 at T = 16
(``ffn._pad_experts``)."""
from repro_torch.configs.base import ArchConfig, register

QWEN2_MOE_A2_7B = register(ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936,
    n_experts=60, top_k=4, n_shared_experts=4, d_ff_expert=1408,
))
