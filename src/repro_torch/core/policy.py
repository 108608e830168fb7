"""Table 1 of the paper: which model-parallel splits admit CDC coding.

A split is suitable iff the parity computation can be derived OFFLINE from
weights alone -- i.e. the split divides the WEIGHT matrix and the OUTPUT but
leaves the INPUT whole. Splits that divide the input would need runtime sums
of activations (2x compute, paper §5.3) or share no factor at all.
"""
from __future__ import annotations

import dataclasses
import enum


class Layer(enum.Enum):
    FC = "fc"
    CONV = "conv"


@dataclasses.dataclass(frozen=True)
class SplitMethod:
    name: str
    layer: Layer
    divides_input: bool
    divides_weight: bool
    divides_output: bool

    @property
    def suitable_for_cdc(self) -> bool:
        """Paper Table 1: suitable <=> splits weights/output, not input."""
        return (self.divides_weight and self.divides_output
                and not self.divides_input)

    @property
    def why(self) -> str:
        if self.suitable_for_cdc:
            return ("parity weights are input-independent column sums, "
                    "computed offline; parity work is shaped like shard work")
        if self.divides_input and self.divides_weight:
            return ("partial sums share no factor between devices (paper "
                    "Eq. 13-14); a parity device would redo the entire GEMM")
        if self.divides_input:
            return ("parity over inputs must be summed at runtime "
                    "(2x compute) because activations change per request")
        return "does not divide weights; nothing to encode offline"


# The five methods of paper §4, with the division pattern of §5.1.
OUTPUT_SPLIT = SplitMethod("output", Layer.FC, False, True, True)
INPUT_SPLIT = SplitMethod("input", Layer.FC, True, True, False)
CHANNEL_SPLIT = SplitMethod("channel", Layer.CONV, False, True, True)
SPATIAL_SPLIT = SplitMethod("spatial", Layer.CONV, True, False, True)
FILTER_SPLIT = SplitMethod("filter", Layer.CONV, True, True, True)

ALL_METHODS = (OUTPUT_SPLIT, INPUT_SPLIT, CHANNEL_SPLIT, SPATIAL_SPLIT,
               FILTER_SPLIT)

# Expected verdicts straight from Table 1 -- tests assert the predicate
# reproduces the paper's column.
TABLE_1 = {
    "output": True,
    "input": False,
    "channel": True,
    "spatial": False,
    "filter": False,
}


def suitability_table() -> list[dict]:
    return [
        {
            "layer": m.layer.value,
            "method": m.name,
            "divides_input": m.divides_input,
            "divides_weight": m.divides_weight,
            "divides_output": m.divides_output,
            "suitable": m.suitable_for_cdc,
            "why": m.why,
        }
        for m in ALL_METHODS
    ]
