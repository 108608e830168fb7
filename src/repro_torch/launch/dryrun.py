"""Dry run: build every (arch x shape x mesh) cell on the meta device and
run one rank's step on it, counting its cost.

The reference's dry run lowers and compiles each cell's jitted step with
XLA on a fake 512-device mesh; that is its proof that the distribution
config is coherent without real hardware. Here the meta device stands in
for XLA's lower and compile: a cell's params are built on it (shapes and
dtypes, nothing allocated), and the step runs on meta tensors at the
per-rank batch, so every shape of the path must cohere:

  train    one microbatch's loss and its backward (remat "full"), then
           one AdamW update on rank 0's blocks of the params
  prefill  ``init_decode`` plus ``decode(last_only=True)``
  decode   one token against a ``seq_len`` cache

The meshes are ``dist.Mesh`` metadata with no world: the production
(data 16, model 16) and (pod 2, data 16, model 16), and with ``--smoke``
(2, 4) and (2, 2, 2). The step runs as one process of the world would run
it with whole activations (the MoE's local path: its expert-parallel path
needs a world).

The record of a cell holds, under the reference's field names:

  * ``params``: the reference's census (``count_params``: no parity, no
    embedding, the MoE's routed experts by top_k / E_pad); ``model_flops``
    a chip, as the reference counts them (6 or 2 x active x tokens /
    chips);
  * ``bytes_rank0``: rank 0's bytes of params, optimizer state and decode
    state from its blocks under ``param_specs`` and ``state_specs``;
    ``microbatches``;
  * ``cost`` {flops, bytes, custom_calls_uncosted}: the step counted on
    the meta tensors by ``obs.perf.CostCounter`` (dot FLOPs of every
    matmul, bytes of every launched op's operands and outputs, each
    kernel wrapper's own cost model: its plain version runs on meta).
    A train cell's is the step the reference compiles (a coded cell's
    under the all-true mask, the recovery math included): the counted
    microbatch's forward and backward (under grad mode, so the
    rematerialised forward counts) times ``microbatches``, plus the
    update (the global norm over the whole gradient and AdamW over rank
    0's blocks). The float32 sum of the microbatches' gradients and the
    averaging after the all-reduce are not counted; neither are the
    FLOPs of convolutions (the dot table has none: whisper's front end
    counts its bytes only). ``custom_calls_uncosted`` counts kernel
    launches with no cost model (0);
  * ``collectives`` (ring-model wire bytes by kind, and their total) and
    ``collective_counts``: for a train cell the messages ``Trainer(mesh=)``
    sends a rank a step (``train.trainer.mesh_step_messages``: an
    all-gather over the world a sharded leaf, an all-reduce over the
    batch line for each gradient the loss reads, one for the loss),
    through ``roofline.analysis.wire_bytes``. The trainer's step runs
    with no mask, so the gradients read are those of an unmasked step on
    the meta tensors: a coded cell's parity leaves get none and are not
    all-reduced (``cost`` counts the masked step, as above). Prefill and
    decode cells say null: the port runs a model line's serving work in
    one process and sends no message on that path, so there is nothing
    to reckon (its distributed coded GEMM, ``dist.collectives``, is a
    library entry, not the served round);
  * ``roofline`` {compute_s, memory_s, collective_s, dominant,
    useful_ratio, roofline_fraction, model_flops}: ``roofline_terms`` and
    ``roofline_report`` at one H100's bf16 rates (the params' dtype:
    989 TFLOP/s, 3.35 TB/s, NVLink 450 GB/s; the data sheet's, at 700
    W). ``useful_ratio`` is model FLOPs over counted FLOPs: a train
    cell's rank computes the whole model on its batch block, so the
    ratio is at most about 1 / (model axis).

There is no compiled memory analysis and no lower or compile time; the
step's wall time is ``step_s``.

Results cache into a JSON file keyed by cell; finished cells are skipped.
Exits 1 if any cell of the run is an error.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --smoke --coded \\
      --mesh both --all
"""
from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time
import traceback

import numpy as np
import torch

from repro_torch.configs import (SHAPES, ShapeSpec, all_archs, get_arch,
                                 runnable, smoke_config)
from repro_torch.dist.sharding import (block_index, local_shard,
                                       paired_leaves, param_specs,
                                       state_specs)
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import TPCtx, build
from repro_torch.obs.perf import CostCounter, counted
from repro_torch.optim import AdamWConfig, adamw, init_state
from repro_torch.roofline.analysis import (hw_for, roofline_report,
                                           roofline_terms, wire_bytes)
from repro_torch.train.train_step import (TrainConfig, _split,
                                          make_loss_fn, value_and_grad)
from repro_torch.train.trainer import mesh_step_messages
from repro_torch.tree import named_leaves, tree_map

DEFAULT_OUT = os.path.join(tempfile.gettempdir(), "repro_dryrun.json")

# --smoke: reduced configs, (2, 4) / (2, 2, 2) test meshes
SMOKE_SHAPES: dict[str, ShapeSpec] = {
    "train_smoke": ShapeSpec("train_smoke", 64, 8, "train"),
    "decode_smoke": ShapeSpec("decode_smoke", 128, 8, "decode"),
}
DTYPE = torch.bfloat16           # the reference's dry-run params


def count_params(params, cfg) -> tuple[int, int]:
    """Exact (active, total) parameter census of a param tree (meta
    tensors will do). Excludes parity leaves (redundant by construction)
    and the embedding table (a lookup is not matmul FLOPs); MoE active =
    total minus the (1 - top_k / E_pad) unrouted share of the expert
    weights."""
    total = active = 0
    for name, leaf in named_leaves(params):
        if name.endswith("cdc") or name.split("/")[-1] == "embed":
            continue
        n = math.prod(leaf.shape)
        total += n
        if name.split("/")[-1] in ("we1", "we2", "we3"):
            e_pad = leaf.shape[-3] if leaf.ndim == 3 else leaf.shape[1]
            active += n * cfg.top_k / max(e_pad, 1)
        else:
            active += n
    return int(active), int(total)


def microbatches_for(cfg, shape, n_batch_devs: int = 16) -> int:
    """Grad-accum splits keeping per-device microbatch activations bounded
    (and the per-microbatch batch divisible by the batch-device count)."""
    if shape.kind != "train":
        return 1
    if cfg.d_model >= 8192 or cfg.n_layers >= 90:
        mb = 16
    elif cfg.d_model >= 4096:
        mb = 8
    else:
        mb = 4
    if cfg.n_experts:
        # the reference's choice: fewer, fatter microbatches for the MoE
        # (each one re-gathers the FSDP-sharded expert weights a layer)
        mb = min(mb, 4)
    return min(mb, max(shape.global_batch // n_batch_devs, 1))


def input_specs(model, shape, mesh) -> dict:
    """Meta stand-ins of the step's global inputs: [global_batch, seq_len]
    for train and prefill, one token a sequence for decode."""
    seq = 1 if shape.kind == "decode" else shape.seq_len
    return model.input_spec(shape.global_batch, seq)


def _rank0_bytes(tree, specs, mesh, itemsize: int | None = None) -> int:
    """Bytes of rank 0's blocks of ``tree`` under ``specs`` (each element
    ``itemsize`` bytes when given, else its leaf's)."""
    out = 0
    for leaf, spec in paired_leaves(tree, specs):
        parts = math.prod(p for _, p in block_index(spec, mesh, 0))
        out += math.prod(leaf.shape) // parts * (itemsize
                                                 or leaf.element_size())
    return out


def _block(x, n: int):
    """The per-rank rows of a global batch input (whole when n does not
    divide it)."""
    b = x.shape[0]
    return x[: b // n] if b % n == 0 else x


def _update_cost(params, grads, specs, mesh) -> CostCounter:
    """The update of a rank's step on the mesh: the global norm over the
    whole gradient, then AdamW over rank 0's blocks of the params, their
    gradients and a fresh optimizer state."""
    def block(x, spec):
        return None if x is None else local_shard(x, spec, mesh, 0)
    mine = tree_map(block, params, specs)
    gmine = tree_map(block, grads, specs)
    state = init_state(mine)
    with counted() as c:
        gnorm = adamw.global_norm(grads)
        adamw.apply_updates(AdamWConfig(), mine, gmine, state, gnorm=gnorm)
    return c


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               coded: bool = False, code_r: int = 2, smoke: bool = False,
               verbose: bool = True) -> dict:
    cfg = get_arch(arch)
    shape = SMOKE_SHAPES.get(shape_name) or SHAPES[shape_name]
    ok, why = runnable(cfg, shape)
    if not ok:
        return {"status": "skip", "why": why}

    if smoke:
        cfg = smoke_config(cfg)
        mesh = make_test_mesh(2, 2, pod=2) if multi_pod \
            else make_test_mesh(2, 4)
    else:
        mesh = make_production_mesh(multi_pod=multi_pod)
    tp = mesh.shape["model"]
    ctx = TPCtx(tp=tp, mode="coded" if coded else "plain", code_r=code_r)
    model = build(cfg, ctx)

    t0 = time.time()
    with torch.no_grad():
        params = model.encode_offline(model.init(0, DTYPE, device="meta"))
    n_batch_devs = mesh.shape.get("pod", 1) * mesh.shape["data"]
    batch = {k: _block(v, n_batch_devs)
             for k, v in input_specs(model, shape, mesh).items()}
    b = batch["tokens"].shape[0]
    # coded cells run the recovery math: the erasure mask is a host input
    # (all true in the fault-free steady state)
    valid = np.ones(tp, bool) if coded else None

    mb = microbatches_for(cfg, shape, n_batch_devs)
    p_spec = param_specs(params, mesh)
    s_bytes = 0
    coll = None
    if shape.kind == "train":
        loss_fn = make_loss_fn(model, TrainConfig(microbatches=mb,
                                                  remat="full"))
        split = b % mb == 0
        mbatch = _split(batch, mb)[0] if split else batch
        with counted() as step:
            _, grads = value_and_grad(loss_fn, params, mbatch, valid)
        upd = _update_cost(params, grads, p_spec, mesh)
        trips = mb if split else 1
        flops = step.flops * trips + upd.flops
        nbytes = step.bytes * trips + upd.bytes
        uncosted = step.custom_calls_uncosted + upd.custom_calls_uncosted
        # the messages are those of Trainer(mesh=), whose step runs with
        # no mask: a coded model's loss then reads no parity leaf
        if valid is not None:
            _, grads = value_and_grad(loss_fn, params, mbatch, None)
        read = {n for n, g in named_leaves(grads) if g is not None}
        coll = wire_bytes(mesh_step_messages(params, mesh, p_spec,
                                             read=read.__contains__))
        # float32 mu, nu and master blocks of every leaf, the int32 step
        opt = 3 * _rank0_bytes(params, p_spec, mesh, itemsize=4) + 4
    else:
        if shape.kind == "decode" and not cfg.n_experts:
            # the serving layout: weights replicated over `data` (the MoE
            # keeps its experts FSDP-sharded)
            p_spec = param_specs(params, mesh, fsdp=None)
        with torch.no_grad():
            if shape.kind == "prefill":
                def serve_step():
                    state = model.init_decode(params, batch, b,
                                              shape.seq_len, DTYPE,
                                              valid=valid)
                    model.decode(params, state, batch["tokens"], valid,
                                 last_only=True)
            else:
                full = model.input_spec(b, shape.seq_len)
                state = model.init_decode(params, full, b, shape.seq_len,
                                          DTYPE)

                def serve_step():
                    model.decode(params, state, batch["tokens"], valid)
            # once uncounted first: a table the step builds once per
            # process and caches (the enc-dec's position table) is no
            # part of a step
            serve_step()
            with counted() as step:
                serve_step()
        flops, nbytes = step.flops, step.bytes
        uncosted = step.custom_calls_uncosted
        # the state of the global batch, cut under state_specs (an empty
        # one: the enc-dec's runs no encoder)
        glob = model.empty_decode(shape.global_batch, shape.seq_len, DTYPE,
                                  device="meta")
        s_bytes = _rank0_bytes(glob, state_specs(glob, mesh), mesh)
        opt = 0
    t_step = time.time() - t0

    chips = mesh.size
    n_active, n_total = count_params(params, cfg)
    if shape.kind == "decode":
        tokens = shape.global_batch          # one token a sequence
        model_flops = 2 * n_active * tokens / chips
    else:
        tokens = shape.global_batch * shape.seq_len
        factor = 6 if shape.kind == "train" else 2
        model_flops = factor * n_active * tokens / chips
    hw = hw_for(DTYPE)
    terms = roofline_terms({"flops": flops, "bytes accessed": nbytes},
                           coll, hw)
    report = roofline_report(terms, model_flops, hw)

    mesh_label = "x".join(str(s) for s in mesh.devices.shape)
    rec = {
        "status": "ok",
        "arch": arch, "shape": shape_name,
        "mesh": ("pod" + mesh_label) if multi_pod else mesh_label,
        "coded": coded,
        "step_s": round(t_step, 2),
        "params": {"total": n_total, "active": n_active},
        "bytes_rank0": {
            "params": _rank0_bytes(params, p_spec, mesh),
            "opt_state": opt, "decode_state": s_bytes},
        "microbatches": mb,
        "model_flops": model_flops,
        "cost": {"flops": flops, "bytes": nbytes,
                 "custom_calls_uncosted": uncosted},
        "collectives": None if coll is None else
        {k: v for k, v in coll.items() if k != "counts"},
        "collective_counts": None if coll is None else coll["counts"],
        "roofline": {k: report[k] for k in
                     ("compute_s", "memory_s", "collective_s", "dominant",
                      "useful_ratio", "roofline_fraction", "model_flops")},
    }
    if verbose:
        print(json.dumps(rec, indent=1, default=str))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + list(SMOKE_SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--coded", action="store_true")
    ap.add_argument("--code-r", type=int, default=2)
    ap.add_argument("--smoke", action="store_true",
                    help="smoke configs on the (2,4)/(2,2,2) test meshes, "
                         "smoke shapes")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)

    if args.smoke:
        archs = [args.arch] if args.arch else (
            sorted(all_archs()) if args.all else ["granite-3-8b"])
        shapes = [args.shape] if args.shape else list(SMOKE_SHAPES)
    else:
        archs = [args.arch] if args.arch else sorted(all_archs())
        shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    run_keys = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = f"{arch}|{shape}|{'multi' if mp else 'single'}" + \
                    ("|coded" if args.coded else "") + \
                    ("|smoke" if args.smoke else "")
                run_keys.append(key)
                if key in results and results[key].get("status") in \
                        ("ok", "skip"):
                    print(f"[cached] {key}")
                    continue
                print(f"[meta step] {key}", flush=True)
                try:
                    rec = lower_cell(arch, shape, multi_pod=mp,
                                     coded=args.coded, code_r=args.code_r,
                                     smoke=args.smoke, verbose=False)
                except Exception as e:  # record the failure, keep going
                    rec = {"status": "error", "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                    print(rec["trace"])
                results[key] = rec
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1, default=str)
                print(f"  -> {rec['status']} (step {rec.get('step_s', '-')}"
                      f"s)", flush=True)

    # status over THIS run's grid only: a reused --out file may hold stale
    # cells from other sweeps that were neither run nor retried
    run = [results[k] for k in run_keys]
    n_ok = sum(1 for r in run if r["status"] == "ok")
    n_skip = sum(1 for r in run if r["status"] == "skip")
    n_err = sum(1 for r in run if r["status"] == "error")
    print(f"done: {n_ok} ok, {n_skip} structured skips, {n_err} errors")
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
