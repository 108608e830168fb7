"""Rank programs of tests/test_torch_dist.py.

Each runs in a process of a ``repro_torch.dist.spawn_world`` world, so this
module imports torch and repro_torch only (never jax: a spawned rank must
not load it). The parent process computes the reference's results and
hands the ranks their inputs as numpy arrays; a rank returns numpy arrays.
"""
import numpy as np
import torch

from repro_torch.core import CodedDenseSpec, CodeSpec
from repro_torch.dist import (Mesh, coded_matmul_shardmap, gather_params,
                              param_specs, pipeline_apply, shard_params)
from repro_torch.dist import comm
from repro_torch.dist.sharding import paired_leaves
from repro_torch.tree import named_leaves, tree_map


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def gemm_case(case: dict, rank: int) -> np.ndarray:
    """One coded GEMM: this rank's block of the merged output."""
    mesh = Mesh(case["mesh"], case["axes"])
    spec = CodedDenseSpec(CodeSpec(case["T"], case["r"]),
                          layout=case["layout"])
    y = coded_matmul_shardmap(_t(case["x"]), _t(case["w"]),
                              _t(case["w_cdc"]), spec, case["valid"],
                              mesh=mesh)
    return _np(y)


def moe_case(case: dict, rank: int) -> np.ndarray:
    """``_moe_sharded`` on the case's mesh: this rank's output rows."""
    from repro_torch.models import TPCtx, ffn
    mesh = Mesh(case["mesh"], case["axes"])
    ctx = TPCtx(mesh=mesh, moe_capacity=case["capacity"])
    p = tree_map(_t, case["params"])
    tp = mesh.shape["model"]
    if case["local_experts"]:
        p = shard_params(p, mesh, rank, fsdp=None)
    e = p["router"]["w"].shape[-1]
    y, _ = ffn._moe_sharded(ctx, p, None, _t(case["x"]), e, case["k"], tp)
    return _np(y)


def forward_case(case: dict, rank: int) -> np.ndarray:
    """``Model.forward`` with ``ctx.mesh``: every rank's whole logits."""
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models import TPCtx, build
    mesh = Mesh(case["mesh"], case["axes"])
    ctx = TPCtx(tp=case["tp"], mesh=mesh, moe_capacity=0)
    model = build(smoke_config(get_arch(case["arch"])), ctx)
    params = params_from_jax(case["params"], ctx, device="cpu")
    return _np(model.forward(params, {"tokens": case["tokens"]}))


def _tanh_layer(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pipeline_case(case: dict, rank: int) -> dict:
    """``pipeline_apply`` over (pod 4), and its two refusals."""
    mesh = Mesh((4,), ("pod",))
    params = tree_map(_t, case["params"])
    x = _t(case["x"])
    out = {"y": _np(pipeline_apply(_tanh_layer, params, x, mesh=mesh,
                                   n_microbatches=4))}
    for what, p, xx in (("layers", tree_map(lambda a: a[:6], params), x),
                        ("batch", params, x[:6])):
        try:
            pipeline_apply(_tanh_layer, p, xx, mesh=mesh, n_microbatches=4)
            out[what] = ""
        except ValueError as e:
            out[what] = str(e)
    return out


def save_case(case: dict, rank: int) -> dict:
    """Cut the params into this rank's blocks (FSDP over data, TP over
    model), gather them back, and save them from the world."""
    from repro_torch.ckpt import save
    mesh = Mesh(case["mesh"], case["axes"])
    full = tree_map(_t, case["params"])
    specs = param_specs(full, mesh, fsdp="data")
    blocks = shard_params(full, mesh, rank, specs=specs)
    back = gather_params(tree_map(lambda b: b.clone(), blocks), mesh, specs)
    equal = all(torch.equal(a, b) for (_, a), (_, b) in
                zip(named_leaves(back), named_leaves(full)))
    sharded = sum(any(a is not None for a in s) for _, s in
                  paired_leaves(full, specs))
    path = save(blocks, case["dir"], case["step"], mesh=mesh, specs=specs)
    return {"gathered_equal": equal, "n_sharded": sharded, "path": path}


def world_main(rank: int, n: int, cases: dict) -> dict:
    """Every case of the 4-rank world, in one order on every rank (each
    mesh makes its process groups at its first collective)."""
    comm.reset()
    with torch.no_grad():
        out = {"gemm": [gemm_case(c, rank) for c in cases["gemm"]],
               "moe": [moe_case(c, rank) for c in cases["moe"]],
               "forward": forward_case(cases["forward"], rank),
               "pipeline": pipeline_case(cases["pipeline"], rank),
               "save": save_case(cases["save"], rank)}
    out["counts"] = dict(comm.COUNTS)
    return out


def restore_main(rank: int, n: int, case: dict) -> dict:
    """Restore the checkpoint onto this world's mesh: this rank's blocks."""
    from repro_torch.ckpt import restore
    from repro_torch.models import TPCtx
    mesh = Mesh(case["mesh"], case["axes"])
    template = tree_map(_t, case["template"])
    specs = param_specs(template, mesh, fsdp=None)
    ctx = TPCtx(tp=case["tp"], mode="coded", code_r=2)
    got = restore(template, case["dir"], case["step"], device="cpu",
                  encode_ctx=ctx, mesh=mesh, shardings=specs)
    return {name: _np(leaf) for name, leaf in named_leaves(got)}


def raising_main(rank: int, n: int) -> None:
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    comm.barrier(comm.world_line())    # rank 0 waits for a rank that died


def hanging_main(rank: int, n: int) -> None:
    import time
    time.sleep(600)
