"""repro_torch.dist — the distribution layer over ``torch.distributed``.

  sharding     the mesh (``Mesh``: axes, ranks, a process group a mesh
               line) and the param/state/batch layout rules (the reference's
               mesh layout contract), with each rank's blocks
               (``shard_params``, ``local_shard``, ``gather_params``)
  comm         the message transport: all-gather, all-reduce, broadcast,
               ring shift, gather; gloo stages CUDA tensors through pinned
               host buffers; bytes counted
  collectives  coded_matmul_shardmap: the per-rank coded GEMM whose parity
               decode crosses the `model` line (all-gather + local decode by
               the decode-and-merge kernel: the paper's master/worker
               message flow)
  pipeline     pipeline_apply: GPipe microbatching over the `pod` axis
  world        spawn_world: one process a rank, results back in rank order

The reference's ``compat`` (a shard_map shim across jax versions) has no
counterpart; in place of its ``param_shardings`` (NamedSharding placement)
a rank takes its blocks with ``shard_params``.
"""
from repro_torch.dist.collectives import coded_matmul_shardmap
from repro_torch.dist.pipeline import pipeline_apply
from repro_torch.dist.sharding import (Mesh, batch_axes, batch_spec,
                                       gather_params, local_shard,
                                       param_specs, shard_params,
                                       state_specs)
from repro_torch.dist.world import spawn_world

__all__ = [
    "batch_axes",
    "batch_spec",
    "coded_matmul_shardmap",
    "gather_params",
    "local_shard",
    "Mesh",
    "param_specs",
    "pipeline_apply",
    "shard_params",
    "spawn_world",
    "state_specs",
]
