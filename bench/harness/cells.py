"""Cells, configurations, traffic mixes, traffic kinds, metrics and
references, each found by its name as a file under ``bench/``:

  bench/workloads/<cell>.json         a cell: configuration, traffic mix,
                                      slots, metrics, check limits
  bench/configs/<config>.json         a configuration as it is run
  bench/traffic/mixes/<traffic>.json  a traffic mix's parameters
  bench/traffic/kinds/<kind>.py       the generator of one kind of mix
  bench/metrics/<metric>.py           one metric's reader
  bench/reference/<reference>.py      a plain reference
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def workload(name: str) -> dict:
    return _json("workloads", name)


def config(name: str) -> dict:
    return _json("configs", name)


def mix(name: str) -> dict:
    return _json("traffic/mixes", name)


def module(kind: str, name: str):
    """Import ``bench/<kind>/<name>.py`` (names may hold dots and dashes)
    under a module name of its own."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    modname = "bench_" + re.sub(r"\W", "_", f"{kind}_{name}")
    mod = sys.modules.get(modname)
    if mod is None:
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        spec.loader.exec_module(mod)
    return mod


def port_arch(cfg: dict):
    """The port's ArchConfig for a configuration file: the port's
    registered architecture with every width set from the file, so the
    run uses the file's numbers. Raises where the file asks for an
    equation the port does not have."""
    import dataclasses

    from repro_torch.configs import get_arch
    if cfg.get("tie_word_embeddings"):
        raise ValueError("the port holds an untied lm_head")
    for key, neutral in (("embedding_multiplier", 1.0),
                         ("residual_multiplier", 1.0),
                         ("logits_scaling", 1.0)):
        if cfg.get(key, neutral) != neutral:
            raise ValueError(f"the port has no {key}")
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or d // h
    if abs(cfg.get("attention_multiplier", hd ** -0.5) - hd ** -0.5) > 1e-12:
        raise ValueError("the port scales scores by head_dim ** -0.5")
    fields = dict(n_layers=cfg["num_hidden_layers"], d_model=d, n_heads=h,
                  n_kv_heads=cfg["num_key_value_heads"], head_dim=hd,
                  vocab=cfg["vocab_size"], rope_theta=cfg["rope_theta"],
                  norm_eps=cfg["rms_norm_eps"], tie_embeddings=False)
    if cfg.get("num_experts"):
        if not cfg.get("norm_topk_prob"):
            raise ValueError("the port renormalises the top-k gates")
        fe = cfg["moe_intermediate_size"]
        shared = cfg.get("shared_expert_intermediate_size", 0)
        if shared % fe:
            raise ValueError("the port's shared experts are whole experts")
        fields.update(d_ff=fe, n_experts=cfg["num_experts"],
                      top_k=cfg["num_experts_per_tok"],
                      n_shared_experts=shared // fe, d_ff_expert=fe)
    else:
        fields.update(d_ff=cfg["intermediate_size"])
    return dataclasses.replace(get_arch(cfg["port_arch"]), **fields)
