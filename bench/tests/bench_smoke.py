"""Smoke-size cells for the CPU tests: the real configurations' keys at
the widths of the port's ``smoke_config``, the real mixes with short
lengths and few clients."""
import copy

from harness import cells

SMALL = dict(hidden_size=128, num_attention_heads=4, head_dim=32,
             vocab_size=512, num_hidden_layers=2,
             attention_multiplier=32 ** -0.5)


def config(name: str) -> dict:
    cfg = dict(cells.config(name), **SMALL)
    if cfg.get("num_experts"):
        cfg.update(num_key_value_heads=4, num_experts=8,
                   num_experts_per_tok=2, moe_intermediate_size=64,
                   shared_expert_intermediate_size=64,
                   intermediate_size=64)
    else:
        cfg.update(num_key_value_heads=2, intermediate_size=256)
    return cfg


def mix(name: str) -> dict:
    m = copy.deepcopy(cells.mix(name))
    p = m["params"]
    p["clients"] = 4
    for key in ("prompt", "output"):
        p[key].update(min=min(p[key]["min"], 4), max=min(p[key]["max"], 24))
        if "median" in p[key]:
            p[key]["median"] = 8
    return m


def cell(cell_name: str, gap_limit: float = 1e-3) -> tuple:
    """(cell, config, mix) of a real cell at smoke size."""
    c = copy.deepcopy(cells.workload(cell_name))
    c.update(slots=4, max_len=64, warmup_s=0.5, per_layer=[],
             check={"tokens": 24, "max_requests": 4,
                    "limits": {"token_gap": gap_limit,
                               "mismatch_share": 0.0}})
    return c, config(c["config"]), mix(c["traffic"])
