"""The paper's contribution: CDC-coded output-split GEMMs (coding algebra,
coded layers) and the straggler model the stepper uses."""
from repro_torch.core.coded_layer import (CodedDenseSpec, coded_matmul,
                                          decode_and_merge, decode_folded,
                                          fold_parity_slots, folded_slot_map,
                                          make_parity_weights, merge_shards,
                                          unfold_parity)
from repro_torch.core.coding import (CodeSpec, decode_outputs,
                                     encode_weights, generator_matrix)
from repro_torch.core.failure import StragglerModel, request_latency

__all__ = [
    "CodeSpec", "CodedDenseSpec", "StragglerModel", "coded_matmul",
    "decode_and_merge", "decode_folded", "decode_outputs", "encode_weights",
    "fold_parity_slots", "folded_slot_map", "generator_matrix",
    "make_parity_weights", "merge_shards", "request_latency", "unfold_parity",
]
