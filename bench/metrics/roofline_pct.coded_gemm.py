"""roofline_pct.coded_gemm: kernel 1's entry, ``kernels/ops.py``
``fused_coded_matmul``: the least time its calls need (``costs.coded_gemm``:
x, w, the parity and the output once; the FLOPs of all T + r shard
products) over their device time, CUDA events around each call, in a
few eager fused rounds of the pool after the window. Layer: kernel 1."""
from harness import readers

UNIT = "%"
RANGES = True


def read(run):
    return readers.roofline_pct(run, "coded_gemm")
