"""The paper's contribution: CDC-coded output-split GEMMs (coding algebra,
coded layers), the convolution in the paper's GEMM form with channel
splitting (``conv``) and the straggler model the stepper uses."""
from repro_torch.core.coded_layer import (CodedDenseSpec, coded_matmul,
                                          decode_and_merge, decode_folded,
                                          fold_parity_slots, folded_slot_map,
                                          make_parity_weights, merge_shards,
                                          pad_for_code, unfold_parity)
from repro_torch.core.coding import (CodeSpec, decode_outputs,
                                     encode_outputs, encode_weights,
                                     generator_matrix, max_decode_condition)
from repro_torch.core.conv import coded_conv2d, conv2d_gemm, im2col
from repro_torch.core.failure import StragglerModel, request_latency

__all__ = [
    "CodeSpec", "CodedDenseSpec", "StragglerModel", "coded_conv2d",
    "coded_matmul", "conv2d_gemm", "decode_and_merge", "decode_folded",
    "decode_outputs", "encode_outputs", "encode_weights",
    "fold_parity_slots", "folded_slot_map", "generator_matrix", "im2col",
    "make_parity_weights", "max_decode_condition", "merge_shards",
    "pad_for_code", "request_latency", "unfold_parity",
]
