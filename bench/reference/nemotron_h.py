"""The plain reference of Nemotron-H (``model_type`` "nemotron_h"): its
forward pass over one whole sequence in plain PyTorch, float32, no cache,
no batching, no kernel, no parity, imports nothing of the program.

It reads the layer pattern and every size from the configuration file
(``hybrid_override_pattern`` cut to ``num_hidden_layers``,
``mamba_num_heads``, ``mamba_head_dim``, ``n_groups``,
``ssm_state_size``, ``conv_kernel``, ``intermediate_size``, the
attention's heads) and the raw weights the benchmark made, in the layout
it hands the program: "embed" [vocab_pad, d]; "layers" grouped by kind,
each group stacked over its own layers in the pattern's order:
"mamba2" {"ln": {"g"}, "mixer": {"in_proj": {"w": [d, z | xBC | dt]},
"conv_w" [K, conv_dim], "conv_b" [conv_dim], "dt_bias", "a_log",
"d_skip" [H], "norm": {"g": [H·P]}, "out_proj": {"w": [H·P, d]}}},
"attn" {"ln", "mixer": {"wq", "wk", "wv", "wo"}}, "mlp" {"ln", "mixer":
{"w1" (up), "w2" (down)}}; "ln_f" {"g"}; "lm_head" {"w": [d,
vocab_pad]}.

Every layer is ``x + mixer(rmsnorm(x))`` (eps ``rms_norm_eps``). The
Mamba-2 mixer (Dao and Gu, arXiv:2405.21060) runs its recurrence one
position at a time, as the published equations read:

    (z, xBC, dt) = split(in_proj(x))
    xBC = silu(causal_conv1d(xBC) + b)
    (x, B, C) = split(xBC)
    dt = softplus(dt + dt_bias);  A = -exp(A_log)
    h = exp(dt·A)·h + dt·x ⊗ B[g];  y = h·C[g] + D·x
                                             (head h: g = h // (H / G))
    out = out_proj(rmsnorm_group(y · silu(z)) · g)

Departures from the published description, each as the configuration
file lists it:

  * float32 with TF32 off (published bfloat16);
  * the attention layers rotate nothing: the published config has no
    rotary key, so they are read as NoPE (an inference);
  * ``time_step_limit`` [0, inf] clamps nothing, so dt is not clamped;
  * the conv weight is held [K, conv_dim] (published [conv_dim, 1, K]),
    the same numbers;
  * the stack is the first ``num_hidden_layers`` layers of the published
    98-layer pattern, with the final norm and the head after them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(x, g, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g


def mamba2(cfg, p, i, x):
    """One Mamba-2 mixer over x [S, d], sequentially."""
    s = x.shape[0]
    nh, hp = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
    g, n, k = cfg["n_groups"], cfg["ssm_state_size"], cfg["conv_kernel"]
    n_in = nh * hp
    cd = n_in + 2 * g * n
    zxbcdt = x @ p["in_proj"]["w"][i][:, :n_in + cd + nh]
    z, xbc, dt = zxbcdt.split([n_in, cd, nh], dim=-1)
    w = p["conv_w"][i]                                   # [K, conv_dim]
    xp = F.pad(xbc, (0, 0, k - 1, 0))
    xbc = sum(xp[j:j + s] * w[j] for j in range(k)) + p["conv_b"][i]
    xbc = F.silu(xbc)
    xs, bm, cm = xbc.split([n_in, g * n, g * n], dim=-1)
    xs = xs.view(s, nh, hp)
    bm = bm.view(s, g, n).repeat_interleave(nh // g, dim=1)   # [S, H, N]
    cm = cm.view(s, g, n).repeat_interleave(nh // g, dim=1)
    dt = F.softplus(dt + p["dt_bias"][i])                # [S, H]
    a = -torch.exp(p["a_log"][i])                        # [H]
    d_skip = p["d_skip"][i]
    h = torch.zeros(nh, hp, n, dtype=x.dtype, device=x.device)
    ys = []
    for t in range(s):
        h = torch.exp(dt[t] * a)[:, None, None] * h \
            + (dt[t][:, None] * xs[t])[:, :, None] * bm[t][:, None, :]
        ys.append((h * cm[t][:, None, :]).sum(-1) + d_skip[:, None] * xs[t])
    y = torch.stack(ys).reshape(s, n_in) * F.silu(z)
    y = y.view(s, g, n_in // g)
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + cfg["rms_norm_eps"])
    y = y.reshape(s, n_in) * p["norm"]["g"][i]
    return y @ p["out_proj"]["w"][i]


def attention(cfg, p, i, x):
    """Causal GQA without position encoding, scores by head_dim ** -0.5."""
    s = x.shape[0]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or cfg["hidden_size"] // h
    q = (x @ p["wq"]["w"][i][:, :h * hd]).view(s, h, hd)
    k = (x @ p["wk"]["w"][i][:, :hkv * hd]).view(s, hkv, hd)
    v = (x @ p["wv"]["w"][i][:, :hkv * hd]).view(s, hkv, hd)
    k = k.repeat_interleave(h // hkv, dim=1)      # query head j: kv j // g
    v = v.repeat_interleave(h // hkv, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) * hd ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    out = torch.einsum("hqk,khd->qhd", probs, v).reshape(s, h * hd)
    return out @ p["wo"]["w"][i][:h * hd]


def mlp(cfg, p, i, x):
    """down(relu(up(x)) ** 2): no gate, no bias."""
    f = cfg["intermediate_size"]
    return torch.square(F.relu(x @ p["w1"]["w"][i][:, :f])) \
        @ p["w2"]["w"][i][:f]


MIXERS = {"M": ("mamba2", mamba2), "*": ("attn", attention),
          "-": ("mlp", mlp)}


@torch.no_grad()
def forward(cfg: dict, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [S] (long, on the weights' device) -> logits [S, vocab]."""
    eps = cfg["rms_norm_eps"]
    pattern = cfg["hybrid_override_pattern"][:cfg["num_hidden_layers"]]
    x = params["embed"][tokens]
    seen = dict.fromkeys(MIXERS, 0)
    for kind in pattern:
        name, mixer = MIXERS[kind]
        group, i = params["layers"][name], seen[kind]
        seen[kind] += 1
        x = x + mixer(cfg, group["mixer"], i,
                      rmsnorm(x, group["ln"]["g"][i], eps))
    x = rmsnorm(x, params["ln_f"]["g"], eps)
    return x @ params["lm_head"]["w"][:, :cfg["vocab_size"]]
