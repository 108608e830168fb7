"""Hand-written CUDA kernels of the port (sources in ``csrc/``), their
plain PyTorch versions (``ref``) and the dispatch layer (``ops``)."""
