"""The reference package's examples (``examples/*.py``), run on the port:

  python -m repro_torch.examples.quickstart      one coded GEMM, a model
                                                 under a dead shard
  python -m repro_torch.examples.serve_cdc       a request stream through
                                                 the coded runtime
  python -m repro_torch.examples.multi_failure   r = 1..4 parity shards
  python -m repro_torch.examples.train_lm        xlstm-125m training

Each computes what its reference script computes, at its sizes, and prints
the same lines; each runs on the CUDA device unless ``--device cpu`` is
given. The work sits in functions over tensors and params, so the same
inputs can be fed to the reference's library.
"""
