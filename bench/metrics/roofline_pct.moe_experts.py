"""roofline_pct.moe_experts: the routed experts, ``models/ffn.py``
``_moe_local``: the least time the routed work needs
(``costs.moe_experts``: each expert a pair routes to read once, the
products of the routed pairs only, the router, the tokens in and out
once) over the device time, CUDA events around each call, in a few
eager fused rounds after the window. Layer: MoE layer."""
from harness import readers

UNIT = "%"
RANGES = True


def read(run):
    return readers.roofline_pct(run, "moe_experts")
