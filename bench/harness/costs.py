"""Operations and bytes counted from shapes: the yardstick of the
roofline and model-FLOPs shares. Counted here, from the configuration's
widths and the calls' shapes, so that a change to the port cannot move
it. Each input byte is counted read once and each output byte written
once; where the work depends on the data (the experts a batch routes
to), what these inputs need is counted, not the most they could."""
from __future__ import annotations

from harness import peaks


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the float32 peak and the bytes over the HBM bandwidth."""
    return max(flops / peaks.F32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)


def coded_gemm(rows: int, k: int, m: int, parity_numel: int,
               itemsize: int = 4) -> tuple[float, float]:
    """(FLOPs, bytes) of one coded GEMM x [rows, k] @ w [k, m] with its
    parity weights (``parity_numel`` elements, r shards of m / T columns
    in either layout): every one of the T + r shard products is required
    work (the parity is computed every round so that a shard lost
    mid-round costs no recovery); x, w, the parity and the output once."""
    parity_cols = parity_numel / k
    flops = 2.0 * rows * k * (m + parity_cols)
    nbytes = itemsize * (rows * k + k * m + parity_numel + rows * m)
    return flops, nbytes


def moe_experts(n_tokens: int, d: int, fe: int, n_experts: int,
                top_k: int, experts_hit: int,
                itemsize: int = 4) -> tuple[float, float]:
    """(FLOPs, bytes) of one routed-expert layer call over ``n_tokens``:
    the router product, the three SwiGLU products of the n * k routed
    pairs only, the weights of each expert that at least one pair routes
    to read once, the router weight once, the tokens in and out once."""
    pairs = n_tokens * top_k
    flops = 2.0 * n_tokens * d * n_experts + pairs * 3 * 2.0 * d * fe
    nbytes = itemsize * (experts_hit * 3 * d * fe + d * n_experts
                         + 2 * n_tokens * d)
    return flops, nbytes


def matmul_params(cfg: dict) -> int:
    """Parameters a token multiplies by in one forward (active ones
    only: a mixture's top-k and shared experts and its router), from the
    configuration's published key names; the embedding lookup is not a
    product."""
    d = cfg["hidden_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // h
    attn = d * h * hd + 2 * d * hkv * hd + h * hd * d
    if cfg.get("num_experts"):
        fe = cfg["moe_intermediate_size"]
        ffn = (d * cfg["num_experts"]
               + cfg["num_experts_per_tok"] * 3 * d * fe
               + 3 * d * cfg.get("shared_expert_intermediate_size", 0))
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * (attn + ffn) + d * cfg["vocab_size"]


def _attn_per_key(cfg: dict) -> float:
    """FLOPs of attention for one query against one key, over all layers:
    the score and the weighted value, 2 products of head_dim each head."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or d // h
    return 4.0 * cfg["num_hidden_layers"] * h * hd


def prefill_flops(cfg: dict, p: int) -> float:
    """Useful FLOPs of a prefill of ``p`` tokens: the products of every
    token and causal attention over the real context (p(p+1)/2 pairs)."""
    return 2.0 * matmul_params(cfg) * p + _attn_per_key(cfg) * p * (p + 1) / 2


def decode_flops(cfg: dict, context: int) -> float:
    """Useful FLOPs of one decoded token that attends ``context`` keys
    (itself included)."""
    return 2.0 * matmul_params(cfg) + _attn_per_key(cfg) * context
