"""The plain reference of the decoder configurations: their forward pass
over one whole sequence in plain PyTorch, float32, no cache, no batching,
no kernel, no parity. It reads the configuration file's keys as they are
run (the port's equations; each departure from the published model is
listed in the file) and the raw weights the benchmark made, and imports
nothing of the program.

Weights are read by the layout the benchmark hands the port: "embed"
[vocab_pad, d]; "layers" stacked [L, ...]: "ln1"/"ln2" {"g"}, "attn"
{"wq", "wk", "wv", "wo"} {"w": [in, out]}, then "ffn" {"w1", "w3", "w2"}
or "moe" {"router": {"w": [d, E]}, "we1"/"we3": [E, d, fe], "we2": [E,
fe, d], "shared": {"w1", "w3", "w2"}}; "ln_f" {"g"}; "lm_head" {"w": [d,
vocab_pad]}.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(x, g, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g


def rope(x, pos, theta):
    """x [S, H, hd]: the two halves of each head rotated by position."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos[:, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos,
                      x[..., 2 * half:]], dim=-1)


def swiglu(x, w1, w3, w2):
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def attention(cfg, p, i, x, pos):
    s = x.shape[0]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or cfg["hidden_size"] // h
    q = (x @ p["wq"]["w"][i][:, :h * hd]).view(s, h, hd)
    k = (x @ p["wk"]["w"][i][:, :hkv * hd]).view(s, hkv, hd)
    v = (x @ p["wv"]["w"][i][:, :hkv * hd]).view(s, hkv, hd)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    k = k.repeat_interleave(h // hkv, dim=1)      # query head j: kv j // g
    v = v.repeat_interleave(h // hkv, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) * cfg.get(
        "attention_multiplier", hd ** -0.5)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    out = torch.einsum("hqk,khd->qhd", probs, v).reshape(s, h * hd)
    return out @ p["wo"]["w"][i][:h * hd]


def experts(cfg, p, i, x):
    """Top-k routed experts (softmax over all, then the k largest; the
    gates renormalised where the file says so) plus the shared expert."""
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(x @ p["router"]["w"][i], dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    if cfg.get("norm_topk_prob"):
        gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in torch.unique(idx).tolist():
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        out = swiglu(x[rows], p["we1"][i, e], p["we3"][i, e], p["we2"][i, e])
        y.index_add_(0, rows, out * gates[rows, slot, None])
    sh = p["shared"]
    return y + swiglu(x, sh["w1"]["w"][i], sh["w3"]["w"][i], sh["w2"]["w"][i])


@torch.no_grad()
def forward(cfg: dict, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [S] (long, on the weights' device) -> logits [S, vocab]."""
    eps = cfg["rms_norm_eps"]
    res = cfg.get("residual_multiplier", 1.0)
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = params["embed"][tokens] * cfg.get("embedding_multiplier", 1.0)
    lay = params["layers"]
    for i in range(cfg["num_hidden_layers"]):
        xn = rmsnorm(x, lay["ln1"]["g"][i], eps)
        x = x + res * attention(cfg, lay["attn"], i, xn, pos)
        xn = rmsnorm(x, lay["ln2"]["g"][i], eps)
        if "moe" in lay:
            y = experts(cfg, lay["moe"], i, xn)
        else:
            f = lay["ffn"]
            y = swiglu(xn, f["w1"]["w"][i], f["w3"]["w"][i], f["w2"]["w"][i])
        x = x + res * y
    x = rmsnorm(x, params["ln_f"]["g"], eps)
    if cfg.get("tie_word_embeddings"):
        head = params["embed"][:cfg["vocab_size"]].T
    else:
        head = params["lm_head"]["w"][:, :cfg["vocab_size"]]
    return (x @ head) / cfg.get("logits_scaling", 1.0)
