#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (run from the repo root).

  python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):
  1. print the card's name and power limit; build the CUDA kernels from
     src/repro_torch/csrc (one nvcc per source, in parallel); any ptxas
     spill fails;
  2. hold each kernel against its plain PyTorch version on the card, at
     granite-3-8b's full-width shapes: the parity encode (rtol = atol =
     1e-5; wq, wk, w1 stacked over 40 layers and the head, r = 1..4, both
     layouts, a ragged shape, T = 2, 8 and 16; on bf16 the whole stacked
     encode at N(0, 1) weights within 2e-2, bitwise repeatable), the
     coded GEMM and the fused
     head under the all-valid mask and every single dead shard (float32,
     rtol = atol = 1e-4; the coded GEMM also at (T, r) = (4, 3) dedicated,
     (4, 4) folded, (8, 3) and (8, 4) in both layouts, and T = 16 at r =
     1..4 in both layouts with both producers; the head at T = 16), plus
     an rmsnorm-fold case and a constructed argmax tie across two
     vocabulary tiles; both on bf16 weights within 2e-2 (the reference's
     bf16 oracle bound), every bf16 instantiation launched; the
     decode-and-merge and the r=1 decode (1e-5, every mask with <= 1 dead,
     a NaN in the dead shard, T = 16, the 2048-row shape, both the 16-byte
     and the scalar instantiation), the RMSNorm (1e-5) and the blocked
     GEMM (1e-4, TF32 off), bf16 where a kernel takes it (2e-2, GEMM
     5e-2); kernels 1 and 7 also at the edges of their launch plans (row
     blocks, tile and stage remainders, misaligned views), where every
     instantiation (bulk copies or row copies, 4/8/16 rows a block)
     must launch and repeats must be bitwise equal; kernel 2 also at its
     plan's edges (T = 2, 4, 8, 16; rows 1-17; ragged m_l, k = 4093, an
     offset head, shards apart and stacked; integer-valued inputs, so
     tokens and max equal the plain version's to the bit; float32 and
     bf16) with ties across tiles and across k splits resolving to the
     smaller id, every (T, instantiation) launched, and kernel 6 at rows
     1-1000, d 4096/12800/4093, bf16 and strided rows, bitwise
     repeatable;
  3. serve granite-3-8b at full width (40 layers, d 4096, T=4, r=2 folded,
     float32, random weights from a seeded torch.Generator) through
     ServingEngine.generate: 4 requests, prompt 16, 16 new tokens, fault
     free, with shard 2 killed at step 4, on the reference variant, and on
     it with the norms on their plain version (no kernel at all); the
     token streams must be identical and every fused round must launch the
     coded-GEMM kernel 200 times and the fused head once (its 4-row,
     bulk-copy instantiation). Fused rounds replay captured CUDA graphs
     (one per mask: one replay per fused round, the launches credited to
     the counts) and give the eager fused rounds' tokens fault-free and
     with shard 2 erased; graph and eager rounds are timed in alternating
     blocks in this call, and torch.profiler gives the device time per
     round of each by kernel, and per launch of kernels 2 and 6;
  4. time each kernel at its main-path shape with CUDA events beside its
     plain version, one library call and its bandwidth/compute bound
     (kernel 1 also at 64 rows, kernel 2 at 16, kernels 1 and 2 on bf16
     weights and at T = 16, kernels 3, 5, 6 and 7 at the shapes of their
     own paths; kernels 3 and 5 also by the profiler, at 2048 rows too,
     beside an empty kernel's device time), printing the instantiation
     each took and its ptxas usage;
  5. serve granite-3-8b at full width through the port's serving entry
     point (launch.serve: the continuous-batching scheduler, SimClock, 4
     slots, 8 requests 2 ms apart, prompt 16, 16 new tokens) fault-free,
     under --chaos "exp:mtbf=800,mttr=120" and with --adapt-r as well; every
     request completes with the fault-free run's tokens, the counters equal
     those of the same runs at smoke size on the CPU, the chaos run
     recovers in-step, requeues beyond the budget and re-encodes, the
     planner reaches r=4, every encode launches the encode kernel once per
     parity leaf, and a re-encode of unchanged weights is bitwise equal;
     the re-encode is timed per leaf and whole. Fused rounds replay CUDA
     graphs (one replay per fused round, at most T + 1 graphs per encode,
     dropped at every re-encode and r change). The fault-free and adapt-r
     runs print the --perf line (every launch costed; the fused round's
     bytes bound within 5% of its weights' bytes over the HBM rate), the
     fault-free run writes a --profile trace (the adapt-r run's was 835
     MB and 79 s on a slow host), the chaos run writes a --trace
     validated with every injected erasure linked and 0 dropped events
     and prints the --slo-report;
  6. run the paper's coded-cost study through its port
     (launch.coded_overhead: run() and run_kernels() at the reference's
     defaults, T in {4, 8, 16} x r in {1, 2}), print its rows, require the
     r=1 decode, GEMM and encode kernels to have launched and the coded
     outputs to equal x @ w (within the budget);
  7. drive decode_and_merge(use_fused=True), the decode-and-merge kernel's
     library entry, on a coded GEMM's shard outputs at granite widths with
     each shard dead in turn;
  8. serve granite-3-8b at full width at T = 16 (what launch.serve --coded
     --tp 16 builds: float32, r = 2 folded) through ServingEngine.generate,
     fault-free and with shard 5 killed at step 4, on fused rounds (kernel
     1 200 times a round through both producers, kernel 2 once) replayed
     from CUDA graphs, on eager fused rounds, and on the reference variant:
     identical token streams;
  9. a bf16 coded granite-3-8b at full width (Model.init(dtype=bf16), T =
     4, r = 2 folded): its parity encoded by kernel 4 on bf16, 16 tokens
     served through kernels 1, 2 and 6 on bf16 (200 + 1 + 81 launches a
     round) on graph rounds (the eager fused rounds give the same tokens)
     and on the reference variant; the first served round's max
     logit from the fused round's own kernel-2 call within 6e-2 (the
     reference's bf16 TOL) of the reference round's, and where a fused
     stream leaves the reference one, its token within 6e-2 of the
     reference's max (a rounding tie; the split's top-2 gap is logged);
     the leading tokens on which the streams agree reported, device time
     per round by the profiler.
Every other code width (2 <= T <= 16, 1 <= r <= T) runs kernels 1-5's
generic instantiations (T and r runtime values). Phase 2 also holds each
against its plain version at T in {3, 5, 6, 12} at granite's widths for
that T (kernel 1 within 1e-4 at r in {1, 2, 4, T}, r = 6 at T = 8 and
12, (16, 16), and its plan's edges; kernel 2 within 1e-4 and to the bit
on integer inputs at its plan's edges at T = 3 and 12; kernels 3, 4 and
5 within 1e-5; bf16 for kernels 1, 2 and 4 within 2e-2), every generic
instantiation launched; phase 4 times them at granite's T = 12 shapes,
and phase 7 drives kernels 3 and 5's library entries at T = 12. Kernel
1's row-copy instantiation (box rows that hold each k row from its
first 16-byte granule on, for shapes the copy engine cannot take whole)
is held in phase 2 at every shape it serves (T = 12's w1 and w3, bf16
and odd r at T = 16, the dedicated layout at an odd m_l; 5 masks each,
integer inputs to the bit) and timed in phase 4
(kernel_times.ROWCOPY_TIMED). Then:
 10. serve granite-3-8b at T = 12 (launch.serve --coded --tp 12: r = 2
     folded, float32, heads padded to 36/9 with zero weights): 4 requests,
     prompt 16, 16 new tokens, fault-free and with shard 7 killed at step
     4, on graph rounds, eager fused rounds, the reference variant and
     kernel-free: identical streams; 200 / 1 / 81 launches of kernels 1,
     2 and 6 a fused round; device ms per round by kernel (kernel 1's
     w1 and w3, its row-copy instantiation, in us a launch); kernel 4
     timed on a whole re-encode against its bound; the graph round's
     median must be below the reference variant's;
 11. h2o-danube-1.8b at full width (SWA, window 4096): launch.serve's
     scheduler (4 slots, 8 requests, --perf) with the CPU run's counters,
     then one batch with a 4090-token prompt and 16 new tokens, so decode
     crosses the window: graph, eager, reference and kernel-free streams
     identical, fault-free and with shard 1 dead; 120 / 1 / 49 launches a
     fused round;
 12. deepseek-67b at full width, 12 of its 95 layers (~52 GB with the
     parity; 95 float32 layers would need ~350 GB): 4 requests, prompt 16,
     8 new tokens, fused graph rounds and the reference variant give the
     same streams; 60 / 1 / 25 launches a fused round (kernels 1 and 2 at
     k = 8192). chameleon-34b has the same layer widths and runs at smoke
     size on the CPU only (tests/test_torch_dense_zoo.py);
 13. whisper-medium at full width in 12 + 12 of its 24 + 24 layers (d
     1024, 16/16 heads, d_ff 4096, vocab 51865, 1500 frames; float32, T
     = 4, r = 2 folded,
     seeded random weights and frames): (a) launch.serve's scheduler (4
     slots, 8 requests with fresh frames, prompt 16, 16 new tokens)
     fault-free with --perf and under --chaos "exp:mtbf=800,mttr=120":
     every request completes with the fault-free tokens, counters equal to
     the CPU run's at smoke size, 12 kernel-4 launches per encode, the
     perf line's fused-round bound within 5% of the weights, the
     cross-attention bank and the self-attention cache the round reads;
     (b) one batch of 4 through ServingEngine.generate with frames,
     fault-free and with shard 2 killed at step 4, on graph rounds, eager
     fused rounds, the reference variant and kernel-free (parity encoded
     by kernel 4's plain version): identical streams; 60 / 1 / 0 (5
     a layer) launches of kernels 1, 2 and 6 a fused round, one capture per
     (encode generation, mask) and one replay per fused round; (c) device
     ms per round by kernel, the idle share, graph and eager round
     medians, the admission time (encoder and cross K/V of one request)
     and peak memory. Phase 2 also holds kernels 1, 2 and 4 at whisper's
     widths (k = 1024; the head's 51865 words padded to 51872) against
     their plain versions (1e-4; integer inputs to the bit; padded columns
     never returned), and phase 4 times kernels 1 and 2 there.
 14. xlstm-125m at full width (12 blocks, xLSTM[7:1]: the sLSTM at block
     7; d 768, 4 heads, up-projection 1536, head width 384, vocab 50304;
     float32, T = 4, r = 2 folded, seeded random weights): (a)
     launch.serve's scheduler (4 slots, 8 requests, prompt 16, 16 new
     tokens) fault-free with --perf and under --chaos
     "exp:mtbf=800,mttr=120": every request completes with the fault-free
     tokens, counters equal to the CPU run's at smoke size, 46 kernel-4
     launches per encode, kernel 6 once a round and a prefill, the perf
     line's fused-round bound within 5% of the weights plus the block
     state as the plain recurrences move it (the mLSTM memories in 5
     passes); (b) one batch of 4 with a 300-token prompt (3 chunks of the
     chunkwise prefill, 300 sLSTM steps) and 16 new tokens, fault-free and
     with shard 2 killed at step 4, on graph rounds, eager fused rounds,
     the reference variant and kernel-free: identical streams, every fused
     round's max logit within 1e-4 of the reference round's, 45 / 1 / 1
     launches of kernels 1, 2 and 6 a fused round; (c) on the dedicated
     layout (r = 2) a 2-dead reference round between graph replays, whose
     replays then give the eager rounds' tokens; (d) device ms per round
     by kernel, the idle share, graph, eager and reference round medians,
     the admission prefill and peak memory. Phase 2 also holds kernels 1,
     2 and 4 at xLSTM's widths (up: k 768, m_l 768; wq: k 1536, m_l 384;
     the head: k 768, m_l 12576) against their plain versions, and phase 4
     times kernels 1 and 2 there.
 15. hymba-1.5b at full width in 16 of its 32 layers of SWA attention
     (window 1024) beside a mamba branch; d 1600, 25/5 heads of 64 run
     as 28/7 at T = 4, d_ff 5504, vocab 32001, SSM state 16; float32, T =
     4, r = 2 folded, seeded random weights): (a) launch.serve's
     scheduler as in phase 14, 7 kernel-4 launches per encode, kernel 6
     33 times a round
     and a prefill, the perf line's fused-round bound within 5% of the
     weights, the KV cache and the mamba state as the plain step moves it;
     (b) one batch of 4 with a 1016-token prompt and 16 new tokens (the
     1024-entry ring wraps while the SSM state carries the whole history),
     fault-free and with shard 2 killed at step 4, on graph rounds, eager
     fused rounds, the reference variant and kernel-free: identical
     streams, every fused round's max logit within 1e-4 of the reference
     round's, 96 / 1 / 33 launches of kernels 1, 2 and 6 a fused round,
     none of kernel 1's on the row-copy instantiation, and the fused
     round's perf bound within 5% of the weights, the 1024-entry window
     and the mamba state; (c) a 2-dead reference round between graph
     replays at dedicated r = 2, which leaves the state's own tensors;
     (d) as phase 14's. Phase 2 also holds kernels 1, 2 and 4 at hymba's
     widths (k 1600; wk m_l 112, in_proj 800, w1 1376; the head m_l 8004)
     against their plain versions, and phase 4 times kernels 1 and 2
     there.
 16. the MoE family (the routed experts uncoded, as the reference keeps
     them: routing depends on the input; the shared experts coded): (a)
     kernels 1, 2 and 4 at both MoE configs' widths against their plain
     versions as in phase 2 (qwen2-moe's wq k 2048 m_l 512 and shared w1
     m_l 1408, qwen3-moe's wq k 4096 m_l 2048 and wk m_l 128; both heads'
     151936 words at m_l 37984 with the planted tie; every parity leaf:
     6 for qwen2, 4 for qwen3), and kernels 1 and 2 timed there; (b)
     qwen2-moe-a2.7b at full width in 12 of its 24 layers (d 2048, 16/16
     heads, 60 routed experts of 1408, top-4, 4 shared as one FFN of
     5632, vocab 151936; float32, T = 4, r = 2 folded, capacity 0, ~34 GB
     with the parity): launch.serve's scheduler fault-free with --perf
     (the bound within 5% of every weight but the embedding, all 60 experts
     included, the parity and the KV cache) and under chaos, with the
     CPU run's counters; one batch of 4 with a 64-token prompt and 16 new
     tokens, shard 2 killed at step 4, on graph rounds, eager fused
     rounds, the reference variant and kernel-free: identical streams,
     every fused round's max logit within 1e-4 of the reference round's,
     60 / 1 / 25 launches of kernels 1, 2 and 6 a fused round; the
     batch's perf count within 5% of those bytes and the dispatch's
     buffers; the graph round's device time split into the routed-expert
     products, the routing ops, kernels 1, 2 and 6 and the rest;
     admission, peak memory; (c) qwen3-moe-235b-a22b at full width in 4
     of its 94 layers (d 4096, 64 query heads of 128 over 4 KV heads, 128
     routed experts of 1536, top-8, no shared expert; ~46 GB): the one
     batch as in (b), 12 / 1 / 9 launches a fused round.
 17. training, the reference's launch.train --coded --tp 4 path: (a)
     kernel 6's backward (csrc/rmsnorm_bwd.cu) against its plain version
     at rows 1-8192, d 4096 and 4093, strided rows (dx within 1e-5, dgamma
     within 1e-4 of its largest entry, repeats bitwise equal, bf16
     refused), the autograd Function around kernel 6, and the kernels
     without a backward refusing a requires-grad input; the backward timed
     at the step's [1024, 4096]; (b) granite-3-8b at full width in 4 of
     its 40 layers (float32, T = 4, r = 2 folded, remat "full", batch 8 x
     128 of the synthetic stream, lr 3e-3, warmup 10; ~1.56 B parameters
     with the parity, ~31 GB with AdamW's state) through the port's
     Trainer for 6 steps: every loss finite, 17 + 9 launches of kernel 6
     and its backward a step, none of kernels 1 and 2, kernel 4 at init;
     the same steps kernel-free (plain norms with autograd, plain encode)
     give every loss within 1e-4 and grad_norm within 1e-3; median step,
     tokens/s, peak memory and the profiled step's device time (GEMMs,
     kernel 6 and its backward, the optimizer, the loss, the rest); (c) a
     Trainer of 2 steps writes the async checkpoint at step 2 (19.2 GB:
     the one checkpoint, as a call's disk takes 45 GiB of writes) and
     another resumes there, re-encoding the parity with kernel 4: steps
     1-6 within 1e-5 of (b)'s; (d) with shard 2 dead the loss within 1e-3
     of the fault-free loss and every gradient finite; (e) python -m
     repro_torch.launch.train --smoke --coded --steps 20 on the card exits
     0 with its CSV.
 18. distribution across real processes, one process a rank, every rank on
     the one card (``dist.spawn_world``; gloo, since NCCL refuses two ranks
     of one communicator on one GPU: every message is staged through pinned
     host buffers, so its times are no yardstick for a collective): (a) a
     4-rank world (model 4) runs dist.coded_matmul_shardmap on granite's
     wq, wk and w1 (T = 4, r = 2; 4 and 64 rows; both layouts; the
     all-valid mask, every single dead rank, ranks 1 and 2 dead on the
     dedicated layout): each rank's block within 1e-4 of the single-process
     coded GEMM (kernel 1) and 2e-3 of x @ w, finite although the dead rank
     sent NaN, kernel 3 launched once a call under <= 1 dead on every rank;
     ms a call and bytes a rank printed; (c) the same world runs one
     qwen2-moe layer at full width expert-parallel (15 of 60 experts a
     rank, capacity 1.25, tokens replicated, one all-reduce) on 4 decode
     tokens and a 4 x 128 prefill, within 1e-5 of the single-process
     _moe_local; (d) GPipe over 4 stages of granite's full-width layer (2
     of 8 a stage, plain, kernel 6 in every stage), batch 8 x 128 in 4
     microbatches, within 1e-4 of the 8 layers in order in one process;
     (e) (c)'s layer saved from the 4 ranks restores onto a 2-rank world
     (each rank its own block) and onto this process, every leaf equal to
     the bit; (b) a 12-rank world (the paper's 12 devices) runs wq and w1
     at granite's padded T = 12 widths, folded, every single dead rank,
     with (a)'s checks. Peak device memory printed per rank.
 19. training the other families, and on a mesh (float32, T = 4, r = 2
     folded, remat "full", the train step the Trainer runs): (a)
     qwen2-moe-a2.7b at full width in 2 of its 24 layers (capacity 1.25;
     ~1.95 B parameters with the parity, ~39 GB of AdamW state), batch 8
     x 128 of the synthetic stream; (b) hymba-1.5b in 4 of 32 layers;
     (c) xlstm-125m, all 12 blocks; (d) whisper-medium in 4 + 4 of its 24
     + 24 layers through make_train_step, batch 4 x 128 with frames [4,
     1500, 1024]. Each: the first step's loss and grad_norm within 1e-4
     of a kernel-free step from the same seed (plain norms with autograd,
     plain encode, as phase 17's); then 3 timed steps and one profiled
     (ms a step, tokens/s, peak GiB, device ms by the train.* ranges);
     kernel 6 2n - 1 times a step and its backward n (n the norms of a
     pass; the layers' ones run again under remat), none of kernels 1, 2
     and 4 in a step, kernel 4 twice for each parity leaf at init; (a)
     also the loss with shard 2 dead within 1e-3 of the fault-free loss.
     (e) Trainer(mesh=) on (data 2, model 2): a world of 4 ranks on the
     one card (gloo) trains granite-3-8b in 1 of its 40 layers (767.5 M
     parameters with the parity) for 3 steps: every rank's losses and
     grad norms within 1e-4 of the single-process Trainer's on the card
     (run first, then freed), kernel 6 5 + 3 times a step a rank, and
     each step's comm.COUNTS on every rank (bytes sent, received and
     staged, calls) exactly as reckoned from the leaves' sizes; ms a
     step and peak GiB a rank logged (host-staged gloo on one card is no
     yardstick).
 20. the examples and the history gate (``repro_torch.examples``, each
     through its ``main`` on the card, the kernel counts set to 0 before
     each and read after), each held against the same work on the CPU:
     quickstart (the coded GEMM [8, 256] @ [256, 512] at T = 4, r = 2
     folded with shard 2 dead, within 1e-5 of the fault-free product and
     of the CPU's; smoke granite-3-8b's logits under the dead shard within
     1e-4 of the fault-free ones, and both within 1e-4 of the CPU's on the
     same params), multi_failure (T = 8, r = 1..4 dedicated, up to 20 dead
     subsets each: the decode condition equal to the CPU sweep's, every
     recovered output within ``multi_failure.AGREEMENT[r]`` of the CPU
     sweep's), serve_cdc (smoke h2o-danube-1.8b, 6 arrivals through 2
     slots, shard 1 dead at 5 ms: 6/6 completed, tokens identical to the
     fault-free stream and to the CPU's fault-free stream on the same
     params; kernels 1, 2, 4 and 6 launched, and each, on every input
     signature the stream gave it outside a graph capture, within its
     phase-2 tolerance of its plain version, timed at the largest beside
     its plain version, the library call and its bound), train_lm
     (xlstm-125m at full config, 3 steps at its default 4 x 256: finite
     losses, ms a step, the first apart). Every example's launches by
     kernel and its seconds are logged beside the card's name and power
     limit; serve_cdc's and train_lm's tokens a second go into a
     temporary BENCH history, and ``python -m repro_torch.obs.history
     check`` must exit 0 on it, and 1 with ``--inject-slowdown 0.30``.
Phases 2-20 each log the seconds they took.
Phases 3 and 5 also count the RMSNorm kernel: 2 x 40 + 1 = 81 launches
per decode round (fused and reference variants) and per prefill.
Peak device memory is printed per phase. The line before the last is the
kernel table as JSON; the last line is {"ok": true, "device": {...}}.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense
SPIN_CYCLES = 4_000_000        # ~2.3 ms at 1.75 GHz: covers any enqueue
TOL = dict(rtol=1e-4, atol=1e-4)
T, R = 4, 2
K = 4096
GEMMS = {"wq": 1024, "wk": 256, "wv": 256, "w1": 3200, "w3": 3200}


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def _phase(n: int, what: str):
    """Log the seconds the block took as phase ``n``."""
    t0 = time.perf_counter()
    yield
    log(f"phase {n} ({what}) took {time.perf_counter() - t0:.1f} s")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 2 ----

def _coded_case(m_l: int, rows: int, layout: str, gen: torch.Generator,
                k: int = K, r: int = R, t: int = T, dtype=torch.float32):
    """A coded GEMM's spec, x [rows, k], w [k, t * m_l] and its parity
    (encoded by kernel 4), stored in ``dtype``."""
    from repro_torch.core.coded_layer import (CodedDenseSpec,
                                              make_parity_weights)
    from repro_torch.core.coding import CodeSpec
    spec = CodedDenseSpec(CodeSpec(t, r), layout=layout)
    x = torch.randn((rows, k), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((k, t * m_l), generator=gen, device="cuda")
         / k ** 0.5).to(dtype)
    return spec, x, w, make_parity_weights(w, spec)


def _run_coded(x, w, wc, spec, valid, gamma=None, plain=False):
    """The kernel (or, with plain=True, its plain version on the same card
    tensors) behind ops.fused_coded_matmul, for one mask."""
    from repro_torch.kernels import cdc_matmul, ops
    vh = tuple(bool(v) for v in valid)
    t, r = spec.code.n_shards, spec.code.n_parity
    m_l = w.shape[1] // t
    esel, coef, g = ops.decode_plan(spec, vh, vh, m_l, str(x.device))
    if plain:
        return cdc_matmul.coded_matmul_plain(x, w, wc, spec.layout, t, r, g,
                                             esel, coef, vh, gamma)
    return cdc_matmul.cdc_coded_matmul(x, w, wc, spec.layout, t, r, g, esel,
                                       coef, vh, gamma=gamma)


def _masks(t: int = T):
    """The all-valid mask and every single dead shard."""
    yield (True,) * t
    for d in range(t):
        yield tuple(i != d for i in range(t))


def check_coded_matmul() -> float:
    """Kernel 1 vs its plain version: every GEMM width x rows in {1,4,16}
    x every mask, plus dedicated-layout, ragged-shape (column tile, k
    chunk) and rmsnorm-fold cases."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = 0.0
    cases = [(m_l, rows, "folded", K) for m_l in sorted(set(GEMMS.values()))
             for rows in (1, 4, 16)] + [(1024, 4, "dedicated", K),
                                        (100, 3, "folded", 1000),
                                        (7, 9, "dedicated", 999)]
    for m_l, rows, layout, k in cases:
        spec, x, w, wc = _coded_case(m_l, rows, layout, gen, k)
        for valid in _masks():
            got = _run_coded(x, w, wc, spec, valid)
            want = _run_coded(x, w, wc, spec, valid, plain=True)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **TOL, msg=lambda m: (
                f"coded matmul m_l={m_l} rows={rows} {layout} "
                f"mask={valid}: {m}"))
            worst = max(worst, float((got - want).abs().max()))
    spec, x, w, wc = _coded_case(1024, 4, "folded", gen)
    gamma = 1.0 + 0.1 * torch.randn(K, generator=gen, device="cuda")
    for valid in [(True,) * T, (True, False, True, True)]:
        got = _run_coded(x, w, wc, spec, valid, gamma=gamma)
        want = _run_coded(x, w, wc, spec, valid, gamma=gamma, plain=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
        worst = max(worst, float((got - want).abs().max()))
    log(f"kernel cdc_coded_matmul: {len(cases) * (T + 1) + 2} cases within "
        f"rtol=atol=1e-4 of the plain version, max abs err {worst:.3e}")
    return worst


def _head(cfg, gen):
    from repro_torch.models.common import TPCtx
    m = TPCtx(tp=T).pad_dim(cfg.vocab)
    w = torch.randn((K, m), generator=gen, device="cuda") / K ** 0.5
    w[:, cfg.vocab:] = 0.0
    return w


def _head_views(w, t: int = T):
    """The [t, k, m_l] shards of a head weight [k, t * m_l] (a view) and
    their sum parity as the serving round holds it."""
    from repro_torch.kernels.cdc_decode import head_parity
    w_shards = w.view(w.shape[0], t, -1).permute(1, 0, 2)
    return w_shards, head_parity(w_shards)


def _int_head(shape, gen, lo=-1, hi=1):
    """Integer-valued float32 in [lo, hi]: every sum of the fused head's
    inputs is then exact in float32, in any order, so the kernel and its
    plain version must agree to the bit, ties included."""
    return torch.randint(lo, hi + 1, shape, generator=gen,
                         device="cuda").to(torch.float32)


def _head_pair(x, w_shards, pw, valid, vocab, tol=TOL):
    """Kernel 2 and its plain version on the same card tensors: their
    tokens must be equal; returns (tokens, max abs err of the max)."""
    from repro_torch.kernels import cdc_decode, ref
    tok, vmax = cdc_decode.cdc_fused_head_argmax(x, w_shards, pw, valid,
                                                 vocab=vocab)
    rtok, rmax = ref.fused_head_argmax_ref(x, w_shards, pw,
                                           torch.tensor(valid), vocab)
    torch.cuda.synchronize()
    if not torch.equal(tok, rtok):
        raise AssertionError(f"fused head tokens {tok.tolist()} != plain "
                             f"{rtok.tolist()} (mask {valid}, rows "
                             f"{x.shape[0]}, shards {tuple(w_shards.shape)}, "
                             f"vocab {vocab})")
    torch.testing.assert_close(vmax, rmax, **tol)
    return tok, float((vmax - rmax).abs().max())


def check_fused_head(cfg) -> float:
    """Kernel 2 vs its plain version under every mask at granite's head
    (4 and 12 rows, Gaussian weights), and two planted ties that must
    resolve to the smaller id under every mask: across two column tiles
    and across two k splits (integer-valued weights, so the tie is exact
    on both sides)."""
    from repro_torch.kernels import cdc_decode, cdc_matmul
    gen = torch.Generator(device="cuda").manual_seed(12)
    w = _head(cfg, gen)
    x = torch.randn((4, K), generator=gen, device="cuda")
    w_shards, pw = _head_views(w)
    worst = 0.0
    # every mask at the main path's 4 rows, and 12 rows (two row blocks)
    x12 = torch.randn((12, K), generator=gen, device="cuda")
    for xs, valid in [(x, m) for m in _masks()] + [(x12, (True,) * T)]:
        worst = max(worst, _head_pair(xs, w_shards, pw, valid,
                                      cfg.vocab)[1])
    m_l = w.shape[1] // T
    plan = cdc_decode.head_plan(4, K, m_l, T, cdc_matmul._n_sm(x.device),
                                cdc_decode.head_occupancy(T, 4, True))
    kc = plan.kchunk
    if plan.ksplit < 2 or plan.bn > 9000:
        raise AssertionError(f"the tie cases need split k and several "
                             f"tiles: {plan}")
    # a tie across tiles: gid 1 * m_l + 10 (shard 1, tile 0) and gid 9000
    # (shard 0, a late tile); across splits: gid 3 * m_l + 20 with weights
    # only in split 0's k range and gid 2 * m_l + 40 with them only in
    # split 1's, x repeating itself there. Planted 8s beat every other
    # column (|w| <= 1) by far.
    ties = {"tiles": ((1 * m_l + 10, None), (9000, None)),
            "splits": ((3 * m_l + 20, (0, kc)), (2 * m_l + 40, (kc, 2 * kc)))}
    for name, cols in ties.items():
        w = _int_head((K, T * m_l), gen)
        x = _int_head((4, K), gen, 1, 2)
        for gid, ks in cols:
            w[:, gid] = 0.0 if ks else 8.0
            if ks:
                w[ks[0]:ks[1], gid] = 8.0
        if name == "splits":
            x[:, kc:2 * kc] = x[:, :kc]
        w_shards, pw = _head_views(w)
        want = min(gid for gid, _ in cols)
        for valid in _masks():
            tok, _ = _head_pair(x, w_shards, pw, valid, cfg.vocab)
            if tok.tolist() != [want] * 4:
                raise AssertionError(f"tie across {name} must resolve to "
                                     f"id {want}: {tok.tolist()} (mask "
                                     f"{valid})")
        del w, w_shards, pw
    log(f"kernel cdc_fused_head_argmax: {T + 2} cases equal tokens, max "
        f"within 1e-4 (max abs err {worst:.3e}); ties across tiles and "
        f"across splits -> the smaller id under every mask")
    return worst


def head_variants(bf16: bool = False) -> tuple:
    """Every (T, instantiation) of kernel 2 in one storage type: rows
    blocks of 4, 8 and (up to 11 streams) 16, tensor copies or row copies."""
    from repro_torch.kernels.stream_plan import rb_fits
    return tuple((t, f"rb{rb}-{p}" + ("-bf16" if bf16 else ""))
                 for t in (2, 4, 8, 16) for rb in (4, 8, 16)
                 if rb_fits(rb, t + 1)
                 for p in ("async", "rowcopy"))


def check_head_edges(dtype=torch.float32) -> float:
    """Kernel 2 at the edges of its launch plan, against its plain version
    under every mask with <= 1 dead shard: granite's head at T = 2, 4, 8
    and 16 (T = 2's m_l = 24578 takes the row copies) and rows 1, 4,
    5, 8, 9, 12 and 17 (the row blocks 4 | 8 | 16 and their remainders;
    T = 16 has blocks of 4 and 8 rows), vocab 49155 (it cuts the last
    shard's last tile); T = 2 at an aligned m_l = 12292; ragged m_l 1001
    and 2051 (row copies, each row block) with the vocab cut 7 columns
    short; k = 4093; the head at a 4-byte offset (row copies at
    granite's width); column shards 4 and 8 columns apart (the 2-D map
    at shard offsets off and on a 16-byte boundary) and shards stored one
    after another (the 3-D map). Integer-valued inputs, exact in bf16
    too: tokens and max must equal the plain version's to the bit, ties
    (frequent here) included. Every (T, instantiation) of the storage
    type must launch (on bf16, granite's T = 4 head, whose shards start
    between 16-byte boundaries, with box rows a vector wider than the
    tile), and two launches on the same inputs give the same bits."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import cdc_decode
    vocab = get_arch("granite-3-8b").vocab
    bf16 = dtype == torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(24)
    rows_all = (1, 4, 5, 8, 9, 12, 17)
    ts = (2, 4, 8, 16)
    # (T, m_l, k, rows, offset, vocab, gap between shards: None = stacked)
    cases = [(t, _pad_head(vocab, t), K, rows_all, 0, vocab, 0) for t in ts]
    cases += [(2, 12292, K, (4, 5, 9), 0, 2 * 12292 - 5, 0)]
    cases += [(t, 1001, 4093, (4, 5), 0, t * 1001 - 7, 0) for t in ts]
    cases += [(t, 2051, K, (17,), 0, t * 2051 - 7, 0) for t in ts]
    cases += [(4, 12292, 4093, (4,), 0, vocab, 0),
              (4, 12292, K, (4, 9), 1, vocab, 0)]
    cases += [(4, 2048, K, (4, 9), 0, 4 * 2048 - 7, gap)
              for gap in (4, 8, None)]
    seen, worst, n, lead = set(), 0.0, 0, 0
    for t, m_l, k, rows_list, offset, voc, gap in cases:
        if gap is None:
            buf = w_shards = _int_head((t, k, m_l), gen).to(dtype)
        else:
            buf = _int_head((k, t * (m_l + gap) + offset), gen).to(dtype)
            w_shards = buf[:, offset:].reshape(k, t, m_l + gap)[..., :m_l] \
                .permute(1, 0, 2)
        pw = cdc_decode.head_parity(w_shards)
        for rows in rows_list:
            x = _int_head((rows, k), gen, -2, 2).to(dtype)
            for valid in _masks(t):
                cdc_decode.cdc_fused_head_argmax.variants.clear()
                _, err = _head_pair(x, w_shards, pw, valid, voc)
                variant, = cdc_decode.cdc_fused_head_argmax.variants
                seen.add((t, variant.replace("-lead", "")))
                lead += "-lead" in variant
                if err != 0.0:
                    raise AssertionError(f"fused head max differs by {err} "
                                         f"on exact inputs (T={t}, m_l="
                                         f"{m_l}, k={k}, rows={rows}, "
                                         f"{dtype})")
                worst, n = max(worst, err), n + 1
        del buf, w_shards, pw
    missing = [v for v in head_variants(bf16) if v not in seen]
    if missing or (bf16 and not lead):
        raise AssertionError(f"kernel 2 instantiations never launched: "
                             f"{missing} (launched {sorted(seen)}; "
                             f"{lead} launches with widened boxes)")
    # bitwise repeat at the decode round's split plan, Gaussian inputs
    w = (torch.randn((K, T * 12292), generator=gen, device="cuda")
         / K ** 0.5).to(dtype)
    w_shards, pw = _head_views(w)
    x = torch.randn((4, K), generator=gen, device="cuda")
    a = cdc_decode.cdc_fused_head_argmax(x, w_shards, pw,
                                         (True, False, True, True),
                                         vocab=vocab)
    b = cdc_decode.cdc_fused_head_argmax(x, w_shards, pw,
                                         (True, False, True, True),
                                         vocab=vocab)
    torch.cuda.synchronize()
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
        raise AssertionError("fused head: two launches on the same inputs "
                             "differ")
    log(f"kernel cdc_fused_head_argmax at its plan's edges ({dtype}): {n} "
        f"cases (T 2/4/8/16, rows 1-17, m_l 1001/2051/12292/granite, k "
        f"4093, offset head, shards 4 and 8 columns apart, stacked shards, "
        f"every mask) equal to the plain version to the bit; repeats "
        f"bitwise equal; (T, instantiation) launched "
        f"{sorted(seen)}")
    return worst


def _pad_head(vocab: int, t: int) -> int:
    """m_l of the head shards at t (the vocabulary padded to t * t)."""
    from repro_torch.models.common import TPCtx
    return TPCtx(tp=t).pad_dim(vocab) // t


def check_coded_matmul_r34() -> float:
    """Kernel 1 at the two cases the planner reaches beyond r=2 at T=4:
    (4, 3) dedicated and (4, 4) folded, at the main path's GEMM widths and
    4 rows, under the all-valid mask and every single dead shard."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    worst, n = 0.0, 0
    for r, layout in ((3, "dedicated"), (4, "folded")):
        for m_l in sorted(set(GEMMS.values())):
            spec, x, w, wc = _coded_case(m_l, 4, layout, gen, r=r)
            for valid in _masks():
                got = _run_coded(x, w, wc, spec, valid)
                want = _run_coded(x, w, wc, spec, valid, plain=True)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, **TOL, msg=lambda m: (
                    f"coded matmul (4, {r}) {layout} m_l={m_l} mask={valid}"
                    f": {m}"))
                worst = max(worst, float((got - want).abs().max()))
                n += 1
    log(f"kernel cdc_coded_matmul at (T, r) = (4, 3) dedicated and (4, 4) "
        f"folded: {n} cases within rtol=atol=1e-4 of the plain version, "
        f"max abs err {worst:.3e}")
    return worst


def check_coded_matmul_t8() -> float:
    """Kernel 1 at the cases the planner reaches at T=8 folded (r = 2 x
    the default budget of 2 = 4) and (8, 3): both layouts, granite-3-8b's
    coded GEMM widths divided by 8 (wq 512, wk 128, w1 1600), 4 rows, the
    all-valid mask and every single dead shard."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    worst, n = 0.0, 0
    for r in (3, 4):
        for layout in ("folded", "dedicated"):
            for m_l in (512, 128, 1600):
                spec, x, w, wc = _coded_case(m_l, 4, layout, gen, r=r, t=8)
                for valid in _masks(8):
                    got = _run_coded(x, w, wc, spec, valid)
                    want = _run_coded(x, w, wc, spec, valid, plain=True)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got, want, **TOL,
                                               msg=lambda m: (
                        f"coded matmul (8, {r}) {layout} m_l={m_l} "
                        f"mask={valid}: {m}"))
                    worst = max(worst, float((got - want).abs().max()))
                    n += 1
    log(f"kernel cdc_coded_matmul at (T, r) = (8, 3) and (8, 4), both "
        f"layouts: {n} cases within rtol=atol=1e-4 of the plain version, "
        f"max abs err {worst:.3e}")
    return worst


T16 = 16
GEMMS16 = {"wq": 256, "wk": 64, "w1": 800}   # granite's widths / 16
BF16_TOL = dict(rtol=2e-2, atol=2e-2)         # the reference's bf16 oracle


def _coded_pair(x, w, wc, spec, valid, tol, what: str) -> float:
    """Kernel 1 and its plain version on the same card tensors, within
    ``tol``; returns the max abs error."""
    got = _run_coded(x, w, wc, spec, valid)
    want = _run_coded(x, w, wc, spec, valid, plain=True)
    torch.cuda.synchronize()
    if got.dtype != x.dtype:
        raise AssertionError(f"coded matmul {what}: output {got.dtype}, "
                             f"want x's {x.dtype}")
    torch.testing.assert_close(got, want, **tol, msg=lambda m: (
        f"coded matmul {what} mask={valid}: {m}"))
    return float((got.float() - want.float()).abs().max())


def check_coded_matmul_t16() -> float:
    """Kernel 1 at T = 16 (its (16, 1)-(16, 4) cases), both layouts,
    granite-3-8b's coded GEMM widths divided by 16 (wq 256, wk 64, w1 800:
    folded w1's slices of 50 columns take the copy engine with box rows a
    vector wider than the tile (`-lead`) at r = 2 and 4, and the row
    copies at r = 1 and 3, whose parity rows are no whole 16-byte vectors),
    4 rows, the all-valid mask and every single dead shard, within 1e-4
    of the plain version; 5 and 9 rows take the 8-row blocks (T = 16 has
    no 16-row instantiation). Both producers must launch at both row
    blocks, and the widened boxes at both."""
    from repro_torch.kernels import cdc_matmul
    gen = torch.Generator(device="cuda").manual_seed(26)
    cdc_matmul.cdc_coded_matmul.variants.clear()
    worst, n = 0.0, 0
    cases = [(m_l, 4, layout, r) for layout in ("folded", "dedicated")
             for r in (1, 2, 3, 4) for m_l in GEMMS16.values()]
    cases += [(800, 5, "folded", 3), (800, 9, "folded", 4),
              (256, 9, "folded", 2), (64, 5, "dedicated", 3)]
    for m_l, rows, layout, r in cases:
        spec, x, w, wc = _coded_case(m_l, rows, layout, gen, r=r, t=T16)
        masks = list(_masks(T16)) if rows == 4 else \
            [(True,) * T16, tuple(i != 7 for i in range(T16))]
        for valid in masks:
            worst = max(worst, _coded_pair(
                x, w, wc, spec, valid, TOL,
                f"(16, {r}) {layout} m_l={m_l} rows={rows}"))
            n += 1
    seen = dict(cdc_matmul.cdc_coded_matmul.variants)
    want = {f"rb{rb}-{p}" for rb in (4, 8)
            for p in ("async", "rowcopy", "async-lead")}
    if set(seen) != want:
        raise AssertionError(f"kernel 1 at T = 16 launched {seen}; want "
                             f"every one of {sorted(want)}")
    log(f"kernel cdc_coded_matmul at T = 16, r = 1-4, both layouts: {n} "
        f"cases within rtol=atol=1e-4 of the plain version, max abs err "
        f"{worst:.3e}; launches per instantiation {seen}")
    return worst


def check_coded_matmul_bf16() -> float:
    """Kernel 1 on bf16 storage (x, weights, parity and output bf16; math
    float32) against its plain version within 2e-2, the reference's bf16
    oracle bound: granite-3-8b's GEMMs at T = 4, r = 2 folded (wq, wk, w1;
    4 rows under every mask, 16 and 64 rows), w1 at (4, 4) and wq
    dedicated; the plan's edges (rows 5, 8, 9; k = 4093; m_l = 1000
    dedicated; a ragged m_l = 100 and w's rows at an odd offset, both on
    the row copies); T = 8 at r = 4 and T = 16 at r = 2 (w1 800 on
    row copies, wq 256 on the copy engine); float32 x against bf16 weights
    (float32 out). Every bf16 instantiation (4/8/16 rows, tensor copies or
    row copies) must launch, and repeats at a split plan are bitwise equal."""
    from repro_torch.kernels import cdc_matmul
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(27)
    cdc_matmul.cdc_coded_matmul.variants.clear()
    worst, n = 0.0, 0
    cases = [(m_l, 4, "folded", K, R, T) for m_l in (1024, 256, 3200)]
    cases += [(m_l, rows, "folded", K, R, T) for m_l in (1024, 3200)
              for rows in (5, 8, 9, 16, 64)]
    cases += [(3200, 4, "folded", K, 4, T), (1024, 4, "dedicated", K, R, T),
              (1000, 9, "dedicated", 4093, R, T),
              (100, 5, "folded", 1000, R, T), (512, 4, "folded", K, 4, 8),
              (800, 4, "folded", K, R, T16), (256, 9, "folded", K, R, T16)]
    for m_l, rows, layout, k, r, t in cases:
        spec, x, w, wc = _coded_case(m_l, rows, layout, gen, k, r, t, bf)
        masks = list(_masks(t)) if (rows == 4 and t == T) else \
            [(True,) * t, tuple(i != 1 for i in range(t))]
        for valid in masks:
            worst = max(worst, _coded_pair(
                x, w, wc, spec, valid, BF16_TOL,
                f"bf16 ({t}, {r}) {layout} m_l={m_l} rows={rows} k={k}"))
            n += 1
    # float32 activations against bf16 weights: float32 out
    spec, x, w, wc = _coded_case(1024, 4, "folded", gen, dtype=bf)
    worst = max(worst, _coded_pair(x.float(), w, wc, spec, (True,) * T,
                                   BF16_TOL, "f32 x, bf16 weights"))
    # w's rows at a 2-byte offset: the row copies at granite's widths
    for rows, m_l in ((4, 1024), (9, 3200)):
        spec, x, w, wc = _coded_case(m_l, rows, "folded", gen, dtype=bf)
        wide = torch.zeros((K, T * m_l + 1), device="cuda", dtype=bf)
        wide[:, 1:] = w
        got = _run_coded(x, wide[:, 1:], wc, spec, (True,) * T)
        want = _run_coded(x, w, wc, spec, (True,) * T, plain=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **BF16_TOL)
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        n += 1
    spec, x, w, wc = _coded_case(3200, 4, "folded", gen, dtype=bf)
    a = _run_coded(x, w, wc, spec, (True, True, False, True))
    b = _run_coded(x, w, wc, spec, (True, True, False, True))
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("bf16 coded matmul: two launches differ")
    seen = dict(cdc_matmul.cdc_coded_matmul.variants)
    missing = [v + "-bf16" for v in CODED_VARIANTS if v + "-bf16" not in seen]
    if missing:
        raise AssertionError(f"bf16 instantiations never launched: "
                             f"{missing} (launched {seen})")
    log(f"kernel cdc_coded_matmul on bf16: {n} cases within rtol=atol=2e-2 "
        f"of the plain version (output in x's dtype), max abs err "
        f"{worst:.3e}; repeats bitwise equal; launches per instantiation "
        f"{seen}")
    return worst


def check_fused_head_wide(cfg) -> float:
    """Kernel 2 at granite's head under every mask, Gaussian weights: at
    T = 16 (m_l = 3088, 4 rows, float32, within 1e-4) and on bf16 weights
    at T = 4 (m_l = 12292, read through the 2-D map) and T = 16, with
    float32 x as the serving round gives it and with bf16 x (max within
    2e-2; tokens equal)."""
    from repro_torch.models.common import TPCtx
    gen = torch.Generator(device="cuda").manual_seed(28)
    worst, n = 0.0, 0
    for t, dtype in ((T16, torch.float32), (T, torch.bfloat16),
                     (T16, torch.bfloat16)):
        m = TPCtx(tp=t).pad_dim(cfg.vocab)
        w = torch.randn((K, m), generator=gen, device="cuda") / K ** 0.5
        w[:, cfg.vocab:] = 0.0
        w_shards, pw = _head_views(w.to(dtype), t)
        tol = TOL if dtype == torch.float32 else BF16_TOL
        x = torch.randn((4, K), generator=gen, device="cuda")
        xs = [x] + ([x.to(dtype)] if dtype != torch.float32 else [])
        for xi in xs:
            for valid in _masks(t):
                worst = max(worst, _head_pair(xi, w_shards, pw, valid,
                                              cfg.vocab, tol)[1])
                n += 1
        del w, w_shards, pw
    log(f"kernel cdc_fused_head_argmax at T = 16 (float32, 1e-4) and on "
        f"bf16 weights at T = 4 and 16 (2e-2): {n} cases, equal tokens, "
        f"max abs err {worst:.3e}")
    return worst


CODED_VARIANTS = tuple(f"rb{rb}-{p}" for rb in (4, 8, 16)
                       for p in ("async", "rowcopy"))
MATMUL_VARIANTS = tuple(f"rows-{v}" for v in CODED_VARIANTS) + (
    "square-async", "square-loads")


def check_stream_edges() -> tuple[float, float]:
    """Kernels 1 and 7 at the edges of their launch plans, against their
    plain versions (1e-4, TF32 off): kernel 1 at rows 5, 8 and 9 (the row
    block boundaries 4 | 8 | 16), m_l = 1000 dedicated (not a multiple of
    the column tile), k = 4093 (not a multiple of the stage depth), w's
    rows at an odd stride and offset (the row-copy instantiation, at
    granite's wq and w1 widths), (4, 4) and (8, 4) folded; kernel 7 at
    m = 1, 5, 8, 9, 12, 16 and 17, n = 1000, 2048, 2050 and 70, k = 4093
    and 300, bf16 in. Each instantiation of both kernels must have run, and
    two launches on the same inputs must give bitwise the same output.
    Returns the two kernels' max abs errors."""
    from repro_torch.kernels import cdc_matmul, matmul, ref
    gen = torch.Generator(device="cuda").manual_seed(22)
    cdc_matmul.cdc_coded_matmul.variants.clear()
    matmul.matmul.variants.clear()
    worst, n = 0.0, 0
    cases = [(m_l, rows, "folded", K, R, T) for m_l in (1024, 3200)
             for rows in (5, 8, 9)]
    cases += [(1000, 4, "dedicated", K, R, T), (1024, 4, "folded", 4093, R, T),
              (1024, 5, "folded", 4093, R, T), (3200, 5, "folded", K, 4, T),
              (3200, 9, "folded", K, 4, T), (512, 9, "folded", K, 4, 8),
              (100, 5, "folded", 1000, R, T)]
    for m_l, rows, layout, k, r, t in cases:
        spec, x, w, wc = _coded_case(m_l, rows, layout, gen, k, r, t)
        for valid in ((True,) * t, tuple(i != 1 for i in range(t))):
            got = _run_coded(x, w, wc, spec, valid)
            want = _run_coded(x, w, wc, spec, valid, plain=True)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **TOL, msg=lambda m: (
                f"coded matmul ({t}, {r}) {layout} m_l={m_l} rows={rows} "
                f"k={k} mask={valid}: {m}"))
            worst = max(worst, float((got - want).abs().max()))
            n += 1
    # w's rows at an odd stride and a 4-byte offset: no tensor map can take
    # them, so the same kernel runs with row copies
    for rows, m_l in ((4, 1024), (9, 1024), (9, 3200)):
        spec, x, w, _ = _coded_case(m_l, rows, "folded", gen)
        wide = torch.zeros((K, T * m_l + 1), device="cuda")
        wide[:, 1:] = w
        wv = wide[:, 1:]
        from repro_torch.core.coded_layer import make_parity_weights
        wc = make_parity_weights(wv.contiguous(), spec)
        got = _run_coded(x, wv, wc, spec, (True,) * T)
        want = _run_coded(x, w, wc, spec, (True,) * T, plain=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
        worst = max(worst, float((got - want).abs().max()))
        n += 1
    # bitwise repeat at split plans (w1 and wk at 4 rows)
    for m_l in (3200, 256):
        spec, x, w, wc = _coded_case(m_l, 4, "folded", gen)
        a = _run_coded(x, w, wc, spec, (True, True, False, True))
        b = _run_coded(x, w, wc, spec, (True, True, False, True))
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"coded matmul m_l={m_l}: two launches on "
                                 f"the same inputs differ")
    worst1, worst = worst, 0.0
    mm_cases = [((m, K, 1000), torch.float32, None) for m in (1, 5, 8, 9, 16)]
    mm_cases += [((4, 4093, 4096), torch.float32, None),
                 ((4, 300, 70), torch.float32, None),
                 ((5, 300, 70), torch.float32, None),
                 ((12, 300, 70), torch.float32, None),
                 ((9, 512, 2048), torch.float32, None),
                 ((12, 300, 2050), torch.float32, None),
                 ((17, 300, 96), torch.float32, None),
                 ((100, 300, 70), torch.float32, None),
                 ((4, 512, 512), torch.bfloat16, torch.float32)]
    for (m, k, nn), dt, odt in mm_cases:
        x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
        w = (torch.randn((k, nn), generator=gen, device="cuda")
             / k ** 0.5).to(dt)
        got = matmul.matmul(x, w, out_dtype=odt)
        want = ref.matmul_ref(x, w, odt)
        torch.cuda.synchronize()
        tol = 1e-4 if dt == torch.float32 else 5e-2
        torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                                   msg=lambda s: f"matmul ({m}, {k}, {nn}) "
                                                 f"{dt}: {s}")
        if dt == torch.float32:
            worst = max(worst, float((got - want).abs().max()))
        n += 1
    x = torch.randn((4, K), generator=gen, device="cuda")
    w = torch.randn((K, K), generator=gen, device="cuda")
    if not torch.equal(matmul.matmul(x, w), matmul.matmul(x, w)):
        raise AssertionError("matmul (4, 4096, 4096): two launches on the "
                             "same inputs differ")
    seen = (dict(cdc_matmul.cdc_coded_matmul.variants),
            dict(matmul.matmul.variants))
    missing = [v for v in CODED_VARIANTS if v not in seen[0]] + \
        [v for v in MATMUL_VARIANTS if v not in seen[1]]
    if missing:
        raise AssertionError(f"instantiations never launched: {missing} "
                             f"(launched {seen})")
    log(f"kernels cdc_coded_matmul and matmul at their plans' edges: {n} "
        f"cases within rtol=atol=1e-4 (bf16 5e-2) of the plain versions, "
        f"max abs err {worst1:.3e} / {worst:.3e}; repeats bitwise equal; "
        f"launches per instantiation {seen[0]} / {seen[1]}")
    return worst1, worst


def _dm_plan(spec, valid, m_l):
    from repro_torch.kernels import ops
    vh = tuple(bool(v) for v in valid)
    esel, coef, g = ops.decode_plan(spec, vh, vh, m_l, "cuda")
    return vh, esel, coef, g


def check_decode_merge() -> float:
    """Kernel 3 vs its plain version (rtol = atol = 1e-5 at float32, 2e-2
    at bf16): T in {2, 4, 8} x r in {1, 2} x both layouts x every mask
    with <= 1 dead x rows in {4, 64} x m_l in {3200 (granite w1), 1024
    (wq), 100 (ragged; 104 folded at T=8, which needs m_l % 8 == 0)}; T =
    16 at granite's w1 / 16 (800; folded slices of 50 columns take the
    scalar path); the 2048-row shape [4, 2048, 3200] (float32 and bf16);
    a column plan whose equations differ within a 16-byte group. The dead
    shard's outputs are NaN: the select must keep them out. Both
    instantiations (16-byte groups and scalar) must launch. 2 dead shards
    must take the reference decode_and_merge, launching nothing."""
    from repro_torch.core.coded_layer import CodedDenseSpec, decode_and_merge
    from repro_torch.core.coding import CodeSpec
    from repro_torch.kernels import cdc_matmul, ops
    gen = torch.Generator(device="cuda").manual_seed(17)
    worst, n = 0.0, 0
    cases = [(t, r, layout, rows, m_l, torch.float32)
             for t in (2, 4, 8) for r in (1, 2)
             for layout in ("folded", "dedicated") for rows in (4, 64)
             for m_l in (3200, 1024, 104 if layout == "folded" and t == 8
                         else 100)]
    cases += [(4, 2, "folded", 4, 3200, torch.bfloat16),
              (8, 1, "dedicated", 64, 100, torch.bfloat16),
              (16, 2, "folded", 4, 800, torch.float32),
              (16, 2, "dedicated", 64, 800, torch.bfloat16),
              (4, 2, "folded", 2048, 3200, torch.float32),
              (4, 2, "dedicated", 2048, 3200, torch.float32),
              (4, 2, "folded", 2048, 3200, torch.bfloat16)]
    cdc_matmul.cdc_decode_merge.variants.clear()
    for t, r, layout, rows, m_l, dt in cases:
        spec = CodedDenseSpec(CodeSpec(t, r), layout=layout)
        ys = torch.randn((t, rows, m_l), generator=gen, device="cuda")
        pshape = (t, rows, r * m_l // t) if layout == "folded" \
            else (r, rows, m_l)
        par = torch.randn(pshape, generator=gen, device="cuda").to(dt)
        for valid in _masks(t):
            yv = ys.clone()
            for d in range(t):
                if not valid[d]:
                    yv[d] = float("nan")
            yv = yv.to(dt)
            vh, esel, coef, g = _dm_plan(spec, valid, m_l)
            got = cdc_matmul.cdc_decode_merge(yv, par, layout, t, r, g, esel,
                                              coef, vh)
            want = cdc_matmul.decode_merge_plain(yv, par, layout, t, r, g,
                                                 esel, coef, vh)
            torch.cuda.synchronize()
            tol = 1e-5 if dt == torch.float32 else 2e-2
            torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                                       msg=lambda m: (
                f"decode_merge T={t} r={r} {layout} rows={rows} m_l={m_l} "
                f"{dt} mask={valid}: {m}"))
            if dt == torch.float32:
                worst = max(worst, float((got - want).abs().max()))
            n += 1
    # equations that differ from column to column inside a 16-byte group
    # (no plan of eq12_plan makes them): per-column parity reads
    spec = CodedDenseSpec(CodeSpec(4, 2), layout="dedicated")
    ys = torch.randn((4, 64, 1024), generator=gen, device="cuda")
    par = torch.randn((2, 64, 1024), generator=gen, device="cuda")
    valid = (True, False, True, True)
    vh, _, _, g = _dm_plan(spec, valid, 1024)
    esel = torch.arange(1024, device="cuda", dtype=torch.int32) % 2
    coef = (1.0 / g[esel.long(), 1]).contiguous()
    got = cdc_matmul.cdc_decode_merge(ys, par, "dedicated", 4, 2, g, esel,
                                      coef, vh)
    want = cdc_matmul.decode_merge_plain(ys, par, "dedicated", 4, 2, g, esel,
                                         coef, vh)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    worst, n = max(worst, float((got - want).abs().max())), n + 1
    seen = dict(cdc_matmul.cdc_decode_merge.variants)
    if set(seen) != {"vec", "scalar"}:
        raise AssertionError(f"kernel 3 instantiations launched {seen}")
    # 2 dead shards (in budget for dedicated r=2): the reference path,
    # bit for bit, and no kernel launch
    spec = CodedDenseSpec(CodeSpec(4, 2), layout="dedicated")
    ys = torch.randn((4, 2, 3, 1024), generator=gen, device="cuda")
    par = torch.randn((2, 2, 3, 1024), generator=gen, device="cuda")
    two_dead = np.array([True, False, True, False])
    before = cdc_matmul.cdc_decode_merge.launches
    got = ops.fused_decode_merge(ys, par, spec, two_dead)
    if cdc_matmul.cdc_decode_merge.launches != before or not torch.equal(
            got, decode_and_merge(ys, par, spec, two_dead)):
        raise AssertionError("2 dead shards must take the reference "
                             "decode_and_merge without a kernel launch")
    log(f"kernel cdc_decode_merge: {n} cases (T = 2, 4, 8, 16; r = 1, 2; "
        f"both layouts; rows 4, 64, 2048; m_l 3200, 1024, 800, ragged; NaN "
        f"in the dead shard; bf16 sets; mixed equations in a group) within "
        f"rtol=atol=1e-5 (bf16 2e-2) of the plain version, max abs err "
        f"{worst:.3e}; launches per instantiation {seen}; 2 dead -> the "
        f"reference path")
    return worst


def check_decode() -> float:
    """Kernel 5 vs its plain version (rtol = atol = 1e-5 at float32, 2e-2
    at bf16): T in {2, 4, 8, 16} at [T, 256, 512] (the study's shape) and
    [T, 4, 3200], [4, 2048, 3200] (float32 and bf16) and a ragged [4, 3,
    333] (the scalar path), all valid and every single dead shard; both
    instantiations must launch; a NaN in the dead shard must propagate
    exactly as in the plain version (multiply semantics); 2 dead shards
    must raise."""
    from repro_torch.kernels import cdc_decode, ops, ref
    gen = torch.Generator(device="cuda").manual_seed(18)
    worst, n = 0.0, 0
    cases = [(t, shape, torch.float32) for t in (2, 4, 8, 16)
             for shape in ((256, 512), (4, 3200))]
    cases += [(8, (256, 512), torch.bfloat16), (4, (4, 3200), torch.bfloat16),
              (4, (2048, 3200), torch.float32),
              (4, (2048, 3200), torch.bfloat16),
              (4, (3, 333), torch.float32), (16, (3, 333), torch.bfloat16)]
    cdc_decode.cdc_decode.variants.clear()
    for t, shape, dt in cases:
        y = torch.randn((t,) + shape, generator=gen, device="cuda")
        p = y.sum(0).to(dt)
        y = y.to(dt)
        for valid in _masks(t):
            got = cdc_decode.cdc_decode(y, p, valid)
            want = ref.cdc_decode_ref(y, p, torch.tensor(valid,
                                                          device="cuda"))
            torch.cuda.synchronize()
            tol = 1e-5 if dt == torch.float32 else 2e-2
            torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                                       msg=lambda m: (
                f"decode T={t} {shape} {dt} mask={valid}: {m}"))
            if dt == torch.float32:
                worst = max(worst, float((got - want).abs().max()))
            n += 1
    y = torch.randn((4, 4, 3200), generator=gen, device="cuda")
    p = y.sum(0)
    y[1, :, ::7] = float("nan")
    valid = (True, False, True, True)
    got = cdc_decode.cdc_decode(y, p, valid)
    want = ref.cdc_decode_ref(y, p, torch.tensor(valid, device="cuda"))
    torch.cuda.synchronize()
    if not (torch.equal(got.isnan(), want.isnan()) and got.isnan().any()):
        raise AssertionError("a NaN in the dead shard must propagate as in "
                             "the plain version")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                               equal_nan=True)
    try:
        ops.cdc_decode(y, p, (True, False, False, True))
    except ValueError:
        pass
    else:
        raise AssertionError("cdc_decode must refuse 2 dead shards")
    seen = dict(cdc_decode.cdc_decode.variants)
    if set(seen) != {"vec", "scalar"}:
        raise AssertionError(f"kernel 5 instantiations launched {seen}")
    log(f"kernel cdc_decode: {n} cases (T = 2, 4, 8, 16 at [T, 256, 512] "
        f"and [T, 4, 3200], [4, 2048, 3200], ragged [T, 3, 333], every "
        f"single erasure, bf16 sets) within rtol=atol=1e-5 (bf16 2e-2), max "
        f"abs err {worst:.3e}; launches per instantiation {seen}; NaN in "
        f"the dead shard propagates as in the plain version; 2 dead raise")
    return worst


def check_rmsnorm() -> float:
    """Kernel 6 vs its plain version at d = 4096, eps = 1e-5: rows in {1,
    4, 64, 3000} at float32 (rtol = atol = 1e-5), a [4, 16, 4096] input
    (leading dimensions flattened) and its last positions (rows at a
    stride), and bf16 at 4 and 64 rows (2e-2)."""
    from repro_torch.kernels import ref, rmsnorm
    gen = torch.Generator(device="cuda").manual_seed(19)
    g = 1.0 + 0.1 * torch.randn(K, generator=gen, device="cuda")
    worst, n = 0.0, 0
    cases = [((rows, K), torch.float32) for rows in (1, 4, 64, 3000)]
    cases += [((4, 16, K), torch.float32), ((4, 16, K), "last"),
              ((4, K), torch.bfloat16), ((64, K), torch.bfloat16)]
    for shape, dt in cases:
        x = 3.0 * torch.randn(shape, generator=gen, device="cuda")
        if dt == "last":       # the last position of each row: strided rows
            x, dt = x[:, -1:], torch.float32
        x = x.to(dt)
        got = rmsnorm.rmsnorm(x, g, eps=1e-5)
        want = ref.rmsnorm_ref(x, g, 1e-5)
        torch.cuda.synchronize()
        tol = 1e-5 if dt == torch.float32 else 2e-2
        torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                                   msg=lambda m: f"rmsnorm {shape} {dt}: {m}")
        if dt == torch.float32:
            worst = max(worst, float((got - want).abs().max()))
        n += 1
    log(f"kernel rmsnorm: {n} cases (rows 1, 4, 64, 3000, [4, 16, 4096] "
        f"and its strided last positions at float32, d = 4096, eps = 1e-5; "
        f"bf16 at 4 and 64 rows) within "
        f"rtol=atol=1e-5 (bf16 2e-2), max abs err {worst:.3e}")
    return worst


def check_rmsnorm_edges() -> float:
    """Kernel 6 at the edges of its plan, against its plain version (1e-5,
    bf16 2e-2): rows 1, 4, 64 and 1000 at d = 4096, 12800 and 4093
    (4093: the scalar instantiation), bf16 at 4 and 1000 rows, rows at a
    stride of d + 8 (vectors) and d + 1 (scalar). Every instantiation the
    plan names must launch, and a second launch on the same inputs gives
    the same bits."""
    from repro_torch.kernels import ref, rmsnorm
    gen = torch.Generator(device="cuda").manual_seed(25)
    rmsnorm.rmsnorm.variants.clear()
    cases = [((rows, d), torch.float32, 0)
             for d in (4096, 12800, 4093) for rows in (1, 4, 64, 1000)]
    cases += [((rows, d), torch.bfloat16, 0)
              for d in (4096, 12800, 4093) for rows in (4, 1000)]
    cases += [((64, d), torch.float32, pad)
              for d in (4096, 12800) for pad in (8, 1)]
    want, worst = set(), 0.0
    for (rows, d), dt, pad in cases:
        g = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        base = 3.0 * torch.randn((rows, d + pad), generator=gen,
                                 device="cuda")
        x = base.to(dt)[:, :d]
        got = rmsnorm.rmsnorm(x, g, eps=1e-5)
        again = rmsnorm.rmsnorm(x, g, eps=1e-5)
        plain = ref.rmsnorm_ref(x, g, 1e-5)
        torch.cuda.synchronize()
        tol = 1e-5 if dt == torch.float32 else 2e-2
        torch.testing.assert_close(got, plain, rtol=tol, atol=tol,
                                   msg=lambda m: (f"rmsnorm [{rows}, {d}] "
                                                  f"{dt} pad {pad}: {m}"))
        if not torch.equal(got, again):
            raise AssertionError(f"rmsnorm [{rows}, {d}] {dt} pad {pad}: "
                                 f"two launches differ")
        if dt == torch.float32:
            worst = max(worst, float((got - plain).abs().max()))
        ldx = d + pad if rows > 1 else d
        want.add(rmsnorm.variant(rmsnorm.rmsnorm_plan(
            d, ldx, dt == torch.bfloat16)))
    seen = dict(rmsnorm.rmsnorm.variants)
    if set(seen) != want or not any(v.endswith("scalar") for v in seen):
        raise AssertionError(f"rmsnorm instantiations launched {seen}; the "
                             f"plan names {sorted(want)}")
    log(f"kernel rmsnorm at its plan's edges: {len(cases)} cases (rows "
        f"1-1000, d 4096/12800/4093, bf16, strided rows) within "
        f"rtol=atol=1e-5 (bf16 2e-2), max abs err "
        f"{worst:.3e}; repeats bitwise equal; launches per instantiation "
        f"{seen}")
    return worst


def check_matmul() -> float:
    """Kernel 7 vs its plain version with TF32 off (rtol = atol = 1e-4):
    (512, 512, 512), granite's Wo at 4 rows (4, 4096, 4096) and a ragged
    (100, 300, 70); bf16 in with bf16 and float32 out at 512^3 (5e-2)."""
    from repro_torch.kernels import matmul, ref
    gen = torch.Generator(device="cuda").manual_seed(20)
    worst, n = 0.0, 0
    cases = [((512, 512, 512), torch.float32, None),
             ((4, 4096, 4096), torch.float32, None),
             ((100, 300, 70), torch.float32, None),
             ((512, 512, 512), torch.bfloat16, None),
             ((512, 512, 512), torch.bfloat16, torch.float32)]
    for (m, k, nn), dt, odt in cases:
        x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
        w = (torch.randn((k, nn), generator=gen, device="cuda")
             / k ** 0.5).to(dt)
        got = matmul.matmul(x, w, out_dtype=odt)
        want = ref.matmul_ref(x, w, odt)
        torch.cuda.synchronize()
        tol = 1e-4 if dt == torch.float32 else 5e-2
        torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                                   msg=lambda s: (f"matmul ({m}, {k}, {nn}) "
                                                  f"{dt} -> {odt}: {s}"))
        if dt == torch.float32:
            worst = max(worst, float((got - want).abs().max()))
        n += 1
    log(f"kernel matmul: {n} cases ((512, 512, 512), (4, 4096, 4096), "
        f"ragged (100, 300, 70) at float32 with TF32 off; bf16 in at 512^3) "
        f"within rtol=atol=1e-4 (bf16 5e-2), max abs err {worst:.3e}")
    return worst


def _shards(w: torch.Tensor, t: int) -> torch.Tensor:
    """[(L,) k, m] -> the [(L,) t, k, m/t] column-shard view (no copy)."""
    return w.reshape(w.shape[:-1] + (t, w.shape[-1] // t)).movedim(-2, -3)


def check_encode(cfg) -> float:
    """Kernel 4 vs its plain version (rtol = atol = 1e-5): wq, wk and w1
    stacked over all layers and the head at T=4, r in {1, 2, 3, 4}, both
    layouts; a ragged shape (m_l = 100, k = 1000); T = 2 and T = 8."""
    from repro_torch.core.coding import generator_matrix
    from repro_torch.kernels import cdc_encode as enc
    from repro_torch.models.common import TPCtx
    gen = torch.Generator(device="cuda").manual_seed(15)
    L = cfg.n_layers
    leaves = [("wq", (L, K, T * GEMMS["wq"])), ("wk", (L, K, T * GEMMS["wk"])),
              ("w1", (L, K, T * GEMMS["w1"])),
              ("lm_head", (K, TPCtx(tp=T).pad_dim(cfg.vocab)))]
    cases = [(name, shape, T, r, layout) for name, shape in leaves
             for r in range(1, T + 1) for layout in ("folded", "dedicated")]
    cases += [("ragged", (1000, T * 100), T, 2, "folded"),
              ("ragged", (1000, T * 100), T, 3, "dedicated"),
              ("T=2", (K, 2 * 1024), 2, 1, "dedicated"),
              ("T=8", (K, 8 * 256), 8, 4, "folded")]
    # T=16 (the coded-overhead study's widest code), r = 1..4
    cases += [("T=16", (K, 16 * 256), 16, r, layout) for r in range(1, 5)
              for layout in ("folded", "dedicated")]
    worst, w, current = 0.0, None, None
    for name, shape, t, r, layout in cases:
        if current != (name, shape):
            w = None                       # free the previous leaf first
            w = torch.randn(shape, generator=gen, device="cuda")
            current = (name, shape)
        sh = _shards(w, t)
        g = generator_matrix(t, r)
        got = enc.cdc_encode(sh, g, layout=layout)
        want = enc.encode_plain(sh, g, layout)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: (
                                       f"encode {name} {tuple(shape)} T={t} "
                                       f"r={r} {layout}: {m}"))
        worst = max(worst, float((got - want).abs().max()))
        del got, want
    del w, sh
    torch.cuda.empty_cache()
    log(f"kernel cdc_encode: {len(cases)} cases (wq, wk, w1 stacked over "
        f"{L} layers and the head at T=4, r=1..4, both layouts; ragged "
        f"m_l=100, k=1000; T=2; T=8; T=16 at r=1..4, both layouts) within "
        f"rtol=atol=1e-5 of the plain version, max abs err {worst:.3e}")
    return worst


def check_encode_bf16(cfg) -> tuple[float, float]:
    """Kernel 4 on bf16 shards (bf16 parity, float32 math) against its
    plain version within 2e-2: the whole stacked encode of granite-3-8b
    at T = 4, r = 2 folded (wq, wk, wv, w1, w3 over all layers and the
    head), each leaf encoded twice to the same bits; the dedicated layout,
    a ragged shape (the scalar path) and T = 16 at r = 2. Unit-scale
    N(0, 1) weights, as the CPU test of the plain version holds them:
    parities of typical size 1-4, so rtol = atol = 2e-2 is a few bf16
    steps and a shard dropped from a parity row (an error of ~0.25 or
    more) fails.
    Returns (max abs err, max |parity|)."""
    from repro_torch.core.coding import generator_matrix
    from repro_torch.kernels import cdc_encode as enc
    from repro_torch.models.common import TPCtx
    gen = torch.Generator(device="cuda").manual_seed(29)
    L = cfg.n_layers
    leaves = [(n, (L, K, T * GEMMS[n]), T, R, "folded") for n in GEMMS]
    leaves += [("lm_head", (K, TPCtx(tp=T).pad_dim(cfg.vocab)), T, R,
                "folded"),
               ("wq", (L, K, T * GEMMS["wq"]), T, 3, "dedicated"),
               ("ragged", (1000, T * 100), T, 2, "folded"),
               ("T=16", (K, 16 * 256), 16, 2, "folded")]
    worst = scale = 0.0
    for name, shape, t, r, layout in leaves:
        w = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        sh = _shards(w, t)
        g = generator_matrix(t, r)
        got = enc.cdc_encode(sh, g, layout=layout)
        again = enc.cdc_encode(sh, g, layout=layout)
        want = enc.encode_plain(sh, g, layout)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16 or not torch.equal(got, again):
            raise AssertionError(f"bf16 encode {name}: dtype {got.dtype}, "
                                 f"repeat equal {torch.equal(got, again)}")
        torch.testing.assert_close(got, want, **BF16_TOL, msg=lambda m: (
            f"bf16 encode {name} {shape} T={t} r={r} {layout}: {m}"))
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        scale = max(scale, float(want.float().abs().max()))
        del w, sh, got, again, want
    torch.cuda.empty_cache()
    log(f"kernel cdc_encode on bf16: {len(leaves)} leaves (granite's whole "
        f"stacked encode at T=4, r=2 folded; dedicated; ragged; T=16) within "
        f"rtol=atol=2e-2 of the plain version at N(0, 1) weights (max "
        f"|parity| {scale:.3f}), max abs err {worst:.3e}; every leaf "
        f"encoded twice to the same bits")
    return worst, scale


# ------------------------------------------------ phase 2, any code width --

TS_ANY = (3, 5, 6, 12)     # code widths without an instantiation of their own


def granite_widths(t: int) -> dict:
    """m_l of granite-3-8b's coded GEMMs at code width t, as ``launch.serve
    --coded --tp t`` builds them (heads padded for t, columns to t * t):
    at t = 12 wq 384, wk 96, w1 1068."""
    from repro_torch.configs import get_arch
    from repro_torch.models.attention import attn_dims
    from repro_torch.models.common import TPCtx
    cfg, ctx = get_arch("granite-3-8b"), TPCtx(tp=t)
    hq, hkv, _ = attn_dims(cfg, t)
    return {"wq": ctx.pad_dim(hq * cfg.hd) // t,
            "wk": ctx.pad_dim(hkv * cfg.hd) // t,
            "w1": ctx.pad_dim(cfg.d_ff) // t}


def _generic_variants(rbs, suffix: str, bf16: bool) -> set:
    """Instantiation names of a generic kernel (``-lead`` dropped): rows a
    block x tensor copies or row copies."""
    return {f"rb{rb}-{p}" + ("-bf16" if bf16 else "") + suffix
            for rb in rbs for p in ("async", "rowcopy")}


def check_coded_matmul_any(dtype=torch.float32) -> float:
    """Kernel 1's generic instantiation (T and r runtime values) against
    its plain version, within 1e-4 on float32 and 2e-2 on bf16: granite's
    GEMMs at T in {3, 5, 6, 12} (bf16: 3 and 12) as launch.serve builds
    them (wq, wk, w1: at T = 12 m_l 384, 96 and 1068, whose 89-column
    slices are 4 bytes off a 16-byte boundary and take the row
    copies), r in {1, 2, 4, T}, folded, 4 rows, under the all-valid mask
    and every single dead shard; the dedicated layout; r = 6 at T = 8 and
    12; (16, 16), 32 streams; and the plan's edges at T = 3, 5, 6, 12 and
    16 (rows 1, 5, 9 and 17, k = 4093, a ragged dedicated m_l, slices wide
    enough for 16-row blocks).
    Every generic instantiation of the storage type must launch: one
    stream a consumer warp (``-any``: 4, 8 and 16 rows a block), two
    (``-any2``, 17-24 streams: 4 and 8 rows) and three (``-any3``, 25-32
    streams: 4 rows), bulk copies and row copies; two launches of a
    split plan give the same bits."""
    from repro_torch.kernels import cdc_matmul
    bf16 = dtype == torch.bfloat16
    tol = BF16_TOL if bf16 else TOL
    gen = torch.Generator(device="cuda").manual_seed(40)
    fn = cdc_matmul.cdc_coded_matmul
    fn.variants.clear()
    # (t, r, m_l, rows, layout, k, every single dead shard?)
    cases = [(t, r, m_l, 4, "folded", K, True)
             for t in ((3, 12) if bf16 else TS_ANY)
             for r in sorted({1, 2, 4, t} & set(range(1, t + 1)))
             for m_l in granite_widths(t).values()]
    if not bf16:
        cases += [(t, 2, granite_widths(t)["wq"], 4, "dedicated", K, True)
                  for t in TS_ANY]
        cases += [(t, 6, granite_widths(t)["w1"], 4, "folded", K, True)
                  for t in (8, 12)]
    cases += [(16, 16, 256, 4, "folded", K, True),
              (16, 16, 800, 4, "folded", K, False),
              (16, 15, 800, 4, "folded", K, False),
              (6, 2, 2304, 17, "folded", K, False),
              (6, 2, 2310, 17, "folded", K, False),
              (12, 2, 384, 9, "folded", K, False),
              (12, 2, 1068, 9, "folded", K, False),
              (12, 12, 384, 9, "folded", K, False),
              (12, 12, 1068, 9, "folded", K, False),
              (12, 2, 384, 1, "folded", 4093, False),
              (5, 3, 1001, 5, "dedicated", K, False),
              (3, 2, 4269, 17, "folded", K, False),
              (3, 3, 1410, 5, "folded", 4093, False),
              (3, 1, 4269, 9, "dedicated", K, False)]
    worst, n = 0.0, 0
    for t, r, m_l, rows, layout, k, every in cases:
        spec, x, w, wc = _coded_case(m_l, rows, layout, gen, k, r, t,
                                     dtype)
        masks = list(_masks(t)) if every else \
            [(True,) * t, tuple(i != t // 2 for i in range(t))]
        for valid in masks:
            worst = max(worst, _coded_pair(
                x, w, wc, spec, valid, tol,
                f"({t}, {r}) {layout} m_l={m_l} rows={rows} k={k} {dtype}"))
            n += 1
        del x, w, wc
    spec, x, w, wc = _coded_case(1068, 4, "folded", gen, K, 2, 12, dtype)
    dead = tuple(i != 7 for i in range(12))
    if not torch.equal(_run_coded(x, w, wc, spec, dead),
                       _run_coded(x, w, wc, spec, dead)):
        raise AssertionError("coded matmul (12, 2) w1: two launches on the "
                             "same inputs differ")
    del x, w, wc
    seen = {v.replace("-lead", "") for v in fn.variants}
    want = _generic_variants((4, 8, 16), "-any", bf16) | \
        _generic_variants((4, 8), "-any2", bf16) | \
        _generic_variants((4,), "-any3", bf16)
    if want - seen:
        raise AssertionError(f"kernel 1's generic instantiations never "
                             f"launched: {sorted(want - seen)} (launched "
                             f"{dict(fn.variants)})")
    log(f"kernel cdc_coded_matmul, generic instantiation ({dtype}): {n} "
        f"cases (T {', '.join(map(str, (3, 12) if bf16 else TS_ANY))} at "
        f"granite's widths, r 1/2/4/T, every mask; r = 6 at T = 8 and 12; "
        f"(16, 16); the plan's edges) within rtol=atol={tol['rtol']} of "
        f"the plain version, max abs err {worst:.3e}; repeats bitwise "
        f"equal; launches per instantiation {dict(fn.variants)}")
    return worst


# every shape kernel 1's row-copy instantiation serves (the copy engine
# cannot: a slice, shard or parity row that is no whole number of 16-byte
# vectors): (what, T, r, m_l, layout, storage type, rows)
ROWCOPY_SHAPES = (
    ("T=12 w1/w3 (89-column slices)", 12, 2, 1068, "folded",
     torch.float32, 4),
    ("T=12 w1, 8-row blocks", 12, 2, 1068, "folded", torch.float32, 9),
    ("T=12 w1 bf16 (rows at odd elements)", 12, 2, 1068, "folded",
     torch.bfloat16, 4),
    ("T=16 w1 bf16 (100-byte slices)", 16, 2, 800, "folded",
     torch.bfloat16, 4),
    ("T=16 w1 r=1", 16, 1, 800, "folded", torch.float32, 4),
    ("T=16 w1 r=3", 16, 3, 800, "folded", torch.float32, 4),
    ("T=16 w1 r=5 (2 streams a warp)", 16, 5, 800, "folded",
     torch.float32, 4),
    ("T=16 w1 r=9 (3 streams a warp)", 16, 9, 800, "folded",
     torch.float32, 4),
    ("dedicated, odd m_l (T=4)", 4, 2, 1001, "dedicated", torch.float32, 4),
    ("dedicated, odd m_l (T=12)", 12, 2, 1001, "dedicated", torch.float32,
     5),
)


def _masks2(t: int) -> list:
    """(valid shards, valid parity slots): fault-free, data shard t // 2
    + 1 dead, parity slot 3 dead, device t // 2 + 1 dead (its data shard
    and its parity slot), and data shard t // 2 + 1 with parity slot t //
    2 + 2 dead (two devices, one erasure of each kind)."""
    d = t // 2 + 1
    full = (True,) * t
    dead = tuple(i != d for i in range(t))
    return [(full, full), (dead, full),
            (full, tuple(i != 3 for i in range(t))), (dead, dead),
            (dead, tuple(i != (d + 1) % t for i in range(t)))]


def check_rowcopy(k: int = K, shapes=ROWCOPY_SHAPES) -> tuple[float, float]:
    """Kernel 1's row-copy instantiation at every shape it serves
    (``ROWCOPY_SHAPES``: T = 12's w1 and w3, bf16 at T = 16, odd r at T =
    16, the dedicated layout at an odd m_l; k rows), each plan named
    ``rowcopy``,
    against the plain version: within 1e-4 (bf16 2e-2) on Gaussian inputs
    fault-free, with one data shard dead, one parity slot dead, a device
    dead (its data shard and its slot) and two devices dead (one data
    shard, another slot); on integer-valued inputs to the bit fault-free
    and with a parity slot dead (every sum exact, no decode); two launches
    on the same inputs bitwise equal. Returns the max abs errors (float32,
    bf16)."""
    from repro_torch.core.coded_layer import make_parity_weights
    from repro_torch.kernels import cdc_matmul, ops
    gen = torch.Generator(device="cuda").manual_seed(45)
    fn = cdc_matmul.cdc_coded_matmul
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for what, t, r, m_l, layout, dtype, rows in shapes:
        tol = BF16_TOL if dtype == torch.bfloat16 else TOL
        spec, x, w, wc = _coded_case(m_l, rows, layout, gen, k, r, t, dtype)
        xi = _int_head((rows, k), gen, -2, 2).to(dtype)
        wi = _int_head((k, t * m_l), gen).to(dtype)
        wci = make_parity_weights(wi, spec)
        fn.variants.clear()
        for valid, vpar in _masks2(t):
            esel, coef, g = ops.decode_plan(spec, valid, vpar, m_l, "cuda")
            call = (layout, t, r, g, esel, coef, valid)
            got = fn(x, w, wc, *call)
            again = fn(x, w, wc, *call)
            want = cdc_matmul.coded_matmul_plain(x, w, wc, *call)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), **tol,
                                       msg=lambda m_: (
                                           f"row copies {what} mask={valid} "
                                           f"parity={vpar}: {m_}"))
            if not torch.equal(got, again):
                raise AssertionError(f"row copies {what}: two launches on the "
                                     f"same inputs differ")
            worst[dtype] = max(worst[dtype],
                               float((got.float() - want.float()).abs()
                                     .max()))
            if all(valid):
                a = fn(xi, wi, wci, *call)
                b = cdc_matmul.coded_matmul_plain(xi, wi, wci, *call)
                torch.cuda.synchronize()
                if not torch.equal(a, b):
                    raise AssertionError(f"row copies {what} parity={vpar}: "
                                         f"integer inputs differ from the "
                                         f"plain version")
            n += 1
        variants = set(fn.variants)
        if not variants or not all("-rowcopy" in v for v in variants):
            raise AssertionError(f"row copies {what}: launched {variants}")
        log(f"  {what}: (T, r) = ({t}, {r}) {layout} m_l={m_l} {dtype} "
            f"rows={rows}: {dict(fn.variants)}")
        del x, w, wc, xi, wi, wci
    log(f"kernel cdc_coded_matmul, row-copy instantiation: {n} cases at "
        f"{len(shapes)} shapes (k = {k}), 5 masks each (fault-free, a data "
        f"shard, a parity slot, a device, two devices), within 1e-4 "
        f"(bf16 2e-2) of the plain version, max abs err "
        f"{worst[torch.float32]:.3e} / bf16 {worst[torch.bfloat16]:.3e}; "
        f"integer inputs to the bit; repeats bitwise equal")
    return worst[torch.float32], worst[torch.bfloat16]


def check_head_any(cfg, dtype=torch.float32) -> float:
    """Kernel 2's generic instantiation (T a runtime value) against its
    plain version: granite's head at T in {3, 5, 6, 12} (m_l 16386, 9835,
    8196 and 4104) at 4 rows under every mask with <= 1 dead shard,
    Gaussian float32 (tokens equal, max within 1e-4; bf16: integer-valued
    inputs, equal to the bit); then its plan's edges at T = 3 and 12 on
    integer-valued inputs (tokens and max equal to the bit, ties
    included): rows 1, 4, 5, 9 and 17, an aligned m_l = 2048 and a ragged
    1001 at k = 4093. Every (T, instantiation) must launch: 4, 8 and 16
    rows a block at T = 3, 4 and 8 at T = 12 (13 streams), bulk copies
    and row copies."""
    from repro_torch.kernels import cdc_decode
    bf16 = dtype == torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(41)
    fn = cdc_decode.cdc_fused_head_argmax
    worst, n, seen = 0.0, 0, set()
    for t in TS_ANY:
        m_l = _pad_head(cfg.vocab, t)
        if bf16:
            w = _int_head((K, t * m_l), gen).to(dtype)
            x = _int_head((4, K), gen, -2, 2)
        else:
            w = torch.randn((K, t * m_l), generator=gen, device="cuda") \
                / K ** 0.5
            x = torch.randn((4, K), generator=gen, device="cuda")
        w[:, cfg.vocab:] = 0
        w_shards, pw = _head_views(w, t)
        for valid in _masks(t):
            fn.variants.clear()
            _, err = _head_pair(x, w_shards, pw, valid, cfg.vocab)
            seen |= {(t, v) for v in fn.variants}
            worst, n = max(worst, err), n + 1
        del w, w_shards, pw
    for t in (3, 12):
        for m_l, k, rows_list, voc in (
                (_pad_head(cfg.vocab, t), K, (1, 4, 5, 9, 17), cfg.vocab),
                (2048, K, (4, 5, 17), t * 2048 - 7),
                (1001, 4093, (4, 5, 9), t * 1001 - 7)):
            w = _int_head((k, t * m_l), gen).to(dtype)
            w_shards = w.reshape(k, t, m_l).permute(1, 0, 2)
            pw = cdc_decode.head_parity(w_shards)
            for rows in rows_list:
                x = _int_head((rows, k), gen, -2, 2).to(dtype)
                for valid in _masks(t):
                    fn.variants.clear()
                    _, err = _head_pair(x, w_shards, pw, valid, voc)
                    seen |= {(t, v) for v in fn.variants}
                    if err != 0.0:
                        raise AssertionError(
                            f"fused head max differs by {err} on exact "
                            f"inputs (T={t}, m_l={m_l}, k={k}, rows={rows},"
                            f" {dtype})")
                    n += 1
            del w, w_shards, pw
    got = {(t, v.replace("-lead", "")) for t, v in seen}
    want = {(3, v) for v in _generic_variants((4, 8, 16), "-any", bf16)} | \
        {(12, v) for v in _generic_variants((4, 8), "-any", bf16)}
    if want - got:
        raise AssertionError(f"kernel 2's generic instantiations never "
                             f"launched: {sorted(want - got)} (launched "
                             f"{sorted(got)})")
    log(f"kernel cdc_fused_head_argmax, generic instantiation ({dtype}): "
        f"{n} cases (granite's head at T {TS_ANY}, every mask; the plan's "
        f"edges at T = 3 and 12 equal to the bit) with equal tokens, max "
        f"abs err {worst:.3e}; (T, instantiation) launched {sorted(got)}")
    return worst


def check_elementwise_any() -> tuple[float, float]:
    """Kernels 3 and 5's generic instantiations (T a runtime value) against
    their plain versions within 1e-5 (bf16 2e-2): kernel 3 at granite's wq
    and w1 widths for T in {3, 5, 6, 12} (4 rows), r in {1, 2, 4, T},
    both layouts, under every mask with <= 1 dead shard, NaN in the dead
    shard's outputs (the decode selects, so nothing of it may reach the
    output), 16-byte groups and single columns; kernel 5 on y [T, 4, w1]
    under every mask. Each instantiation (16-byte groups and single
    elements, float32 and bf16) must launch. Returns the two max abs
    errors."""
    from repro_torch.core.coded_layer import CodedDenseSpec
    from repro_torch.core.coding import CodeSpec
    from repro_torch.kernels import cdc_decode, cdc_matmul, ref
    gen = torch.Generator(device="cuda").manual_seed(42)
    dm, dec = cdc_matmul.cdc_decode_merge, cdc_decode.cdc_decode
    dm.variants.clear()
    dec.variants.clear()
    worst3 = worst5 = 0.0
    n3 = n5 = 0
    for t in TS_ANY:
        widths = granite_widths(t)
        for r in sorted({1, 2, 4, t} & set(range(1, t + 1))):
            for layout in ("folded", "dedicated"):
                spec = CodedDenseSpec(CodeSpec(t, r), layout=layout)
                for m_l in (widths["wq"], widths["w1"]):
                    ys = torch.randn((t, 4, m_l), generator=gen,
                                     device="cuda")
                    pshape = (t, 4, r * m_l // t) if layout == "folded" \
                        else (r, 4, m_l)
                    par = torch.randn(pshape, generator=gen, device="cuda")
                    for valid in _masks(t):
                        vh, esel, coef, g = _dm_plan(spec, valid, m_l)
                        y = ys.clone()
                        for d, ok in enumerate(vh):
                            if not ok:
                                y[d] = float("nan")
                        call = (y, par, layout, t, r, g, esel, coef, vh)
                        got = dm(*call)
                        want = cdc_matmul.decode_merge_plain(*call)
                        torch.cuda.synchronize()
                        if not torch.isfinite(got).all():
                            raise AssertionError(
                                f"decode_merge T={t} r={r} {layout}: the "
                                f"dead shard's NaN reached the output")
                        torch.testing.assert_close(
                            got, want, rtol=1e-5, atol=1e-5,
                            msg=lambda m: f"decode_merge T={t} r={r} "
                                          f"{layout} m_l={m_l} {vh}: {m}")
                        worst3 = max(worst3,
                                     float((got - want).abs().max()))
                        n3 += 1
        y = torch.randn((t, 4, widths["w1"]), generator=gen, device="cuda")
        p = torch.randn((4, widths["w1"]), generator=gen, device="cuda")
        for valid in _masks(t):
            got = dec(y, p, valid)
            want = ref.cdc_decode_ref(y, p, torch.tensor(valid))
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            worst5, n5 = max(worst5, float((got - want).abs().max())), n5 + 1
    # bf16: the 16-byte groups (8 columns) and single elements
    spec = CodedDenseSpec(CodeSpec(12, 2))
    for m_l in (384, 1068):
        ys = torch.randn((12, 4, m_l), generator=gen,
                         device="cuda").to(torch.bfloat16)
        par = torch.randn((12, 4, 2 * m_l // 12), generator=gen,
                          device="cuda").to(torch.bfloat16)
        vh, esel, coef, g = _dm_plan(spec, tuple(i != 5 for i in range(12)),
                                     m_l)
        call = (ys, par, "folded", 12, 2, g, esel, coef, vh)
        torch.testing.assert_close(dm(*call).float(),
                                   cdc_matmul.decode_merge_plain(*call)
                                   .float(), **BF16_TOL)
        for yy in (ys, ys[:, :, :m_l - 1].contiguous()):
            pp = yy.sum(0)
            torch.testing.assert_close(
                dec(yy, pp, vh).float(),
                ref.cdc_decode_ref(yy, pp, torch.tensor(vh)).float(),
                **BF16_TOL)
    seen = (dict(dm.variants), dict(dec.variants))
    if any(set(v) != {"vec", "scalar"} for v in seen):
        raise AssertionError(f"kernels 3 / 5 instantiations launched: "
                             f"{seen}; want vec and scalar")
    log(f"kernels cdc_decode_merge / cdc_decode, generic instantiation: "
        f"{n3} / {n5} cases (T {TS_ANY}, every mask; NaN in the dead shard "
        f"for kernel 3) within rtol=atol=1e-5 of the plain versions, max abs "
        f"err {worst3:.3e} / {worst5:.3e}; bf16 within 2e-2; launches "
        f"{seen[0]} / {seen[1]}")
    return worst3, worst5


def check_encode_any() -> tuple[float, float]:
    """Kernel 4's generic instantiation (T and r runtime values) against
    its plain version: granite's w1 and wq at T in {3, 5, 6, 12} (k 4096,
    w1 stacked over 2 layers), r in {1, 2, 4, T}, both layouts, within
    1e-5, each encoded twice to the same bits; on bf16 (N(0, 1) weights)
    T = 12 at r = 2 and 12 within 2e-2; T = 12's w1 (89-column slices)
    must read 16-byte vectors. Returns the max abs errors (float32,
    bf16)."""
    from repro_torch.core.coding import generator_matrix
    from repro_torch.kernels import cdc_encode as enc
    gen = torch.Generator(device="cuda").manual_seed(43)
    worst, worst_bf16, n = 0.0, 0.0, 0
    enc.cdc_encode.variants.clear()
    for t in TS_ANY:
        widths = granite_widths(t)
        for shape in ((2, K, t * widths["w1"]), (K, t * widths["wq"])):
            w = torch.randn(shape, generator=gen, device="cuda")
            sh = _shards(w, t)
            for r in sorted({1, 2, 4, t} & set(range(1, t + 1))):
                for layout in ("folded", "dedicated"):
                    g = generator_matrix(t, r)
                    got = enc.cdc_encode(sh, g, layout=layout)
                    again = enc.cdc_encode(sh, g, layout=layout)
                    want = enc.encode_plain(sh, g, layout)
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise AssertionError(f"encode T={t} r={r}: two "
                                             f"launches differ")
                    torch.testing.assert_close(
                        got, want, rtol=1e-5, atol=1e-5,
                        msg=lambda m: f"encode {shape} T={t} r={r} "
                                      f"{layout}: {m}")
                    worst = max(worst, float((got - want).abs().max()))
                    n += 1
            del w, sh
    # granite's w1 at T = 12 (89-column slices) reads 16-byte vectors and
    # writes each column to its own slot
    if "vec4-columns" not in enc.cdc_encode.variants:
        raise AssertionError(f"encode: T = 12's w1 took "
                             f"{dict(enc.cdc_encode.variants)}, not the "
                             f"16-byte reads")
    w = torch.randn((K, 12 * granite_widths(12)["w1"]), generator=gen,
                    device="cuda").to(torch.bfloat16)
    for r in (2, 12):
        g = generator_matrix(12, r)
        got = enc.cdc_encode(_shards(w, 12), g, layout="folded")
        want = enc.encode_plain(_shards(w, 12), g, "folded")
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
        worst_bf16 = max(worst_bf16,
                         float((got.float() - want.float()).abs().max()))
    log(f"kernel cdc_encode, generic instantiation: {n} cases (granite's "
        f"w1 stacked and wq at T {TS_ANY}, r 1/2/4/T, both layouts) within "
        f"rtol=atol=1e-5 of the plain version, max abs err {worst:.3e}, "
        f"repeats bitwise equal; bf16 at T = 12, r = 2 and 12 within 2e-2 "
        f"(max abs err {worst_bf16:.3e})")
    return worst, worst_bf16


# ------------------------------------------------ phase 2, whisper widths --

WHISPER = "whisper-medium"
WHISPER_LAYERS = 12        # phase 13 serves 12 + 12 of its 24 + 24 layers
XLSTM = "xlstm-125m"
HYMBA = "hymba-1.5b"


def whisper_widths(cfg) -> dict:
    """m_l of whisper-medium's coded GEMMs at T = 4 (k = d = 1024): wq
    (and wk, wv, cross wq) and w1; and its head's."""
    from repro_torch.models.common import TPCtx
    ctx = TPCtx(tp=T)
    return {"wq": ctx.pad_dim(cfg.n_heads * cfg.hd) // T,
            "w1": ctx.pad_dim(cfg.d_ff) // T,
            "lm_head": ctx.pad_dim(cfg.vocab) // T}


def whisper_shapes(cfg) -> dict:
    """Kernel 1's (k, m_l) at wq and w1, kernel 2's head (k, m_l, vocab)
    and kernel 4's leaves (24 layers of wq and w1 stacked, the head) at
    whisper-medium's widths."""
    k, w = cfg.d_model, whisper_widths(cfg)
    return {"gemms": {"wq": (k, w["wq"]), "w1": (k, w["w1"])},
            "head": (k, w["lm_head"], cfg.vocab),
            "encode": [(cfg.n_layers, k, T * w["wq"]),
                       (cfg.n_layers, k, T * w["w1"]), (k, T * w["lm_head"])]}


def xlstm_shapes(cfg) -> dict:
    """The same at xlstm-125m's widths (T = 4): kernel 1 at the mLSTM's
    up (k = d = 768, m_l 768; the sLSTM's wx has its shape) and wq (and
    wk, wv: k = 2d = 1536, m_l 384, 96-column folded slices), kernel 2 at
    the head (k 768, 50304 words, m_l 12576), kernel 4 at their leaves."""
    from repro_torch.models.common import TPCtx
    ctx, d = TPCtx(tp=T), cfg.d_model
    up, wq = ctx.pad_dim(4 * d) // T, ctx.pad_dim(2 * d) // T
    head = ctx.pad_dim(cfg.vocab) // T
    return {"gemms": {"up": (d, up), "wq": (2 * d, wq)},
            "head": (d, head, cfg.vocab),
            "encode": [(d, T * up), (2 * d, T * wq), (d, T * head)]}


def hymba_shapes(cfg) -> dict:
    """The same at hymba-1.5b's widths (T = 4, k = d = 1600): kernel 1 at
    wk (and wv: 7 KV heads of 64, m_l 112, 28-column folded slices),
    in_proj (m_l 800) and w1 (and w3: m_l 1376), kernel 2 at the head
    (32001 words padded to 32016, m_l 8004), kernel 4 at the stacked
    leaves (wq, wk, in_proj, w1 over 32 layers) and the head."""
    from repro_torch.models.attention import attn_dims
    from repro_torch.models.common import TPCtx
    ctx, d, L = TPCtx(tp=T), cfg.d_model, cfg.n_layers
    hq, hkv, _ = attn_dims(cfg, T)
    wq, wk = ctx.pad_dim(hq * cfg.hd) // T, ctx.pad_dim(hkv * cfg.hd) // T
    inp, w1 = ctx.pad_dim(2 * d) // T, ctx.pad_dim(cfg.d_ff) // T
    head = ctx.pad_dim(cfg.vocab) // T
    return {"gemms": {"wk": (d, wk), "in_proj": (d, inp), "w1": (d, w1)},
            "head": (d, head, cfg.vocab),
            "encode": [(L, d, T * wq), (L, d, T * wk), (L, d, T * inp),
                       (L, d, T * w1), (d, T * head)]}


def check_width_kernels(tag: str, shapes: dict
                        ) -> tuple[float, float, float]:
    """Kernels 1, 2 and 4 at one model's widths (``whisper_shapes``,
    ``xlstm_shapes``; T = 4, r = 2 folded), against their plain versions.
    Kernel 1 at each GEMM at rows 1, 4, 5 and 16 (the row blocks' edges;
    k split into ranges with a short last one), under every mask with <= 1
    dead shard within 1e-4 on Gaussian inputs, and on integer-valued
    inputs to the bit under the all-valid mask (every sum exact; a dead
    shard's decode multiplies by the generator's non-integer rows); two
    launches bitwise equal. Kernel 2 at the head at rows 1, 4 and 5 under
    every mask: within 1e-4 on Gaussian inputs, and on integer inputs to
    the bit with the largest logits planted in the padded columns (never
    returned) and a tie between two words in different shards and tiles
    (the smaller id wins). Kernel 4 on the leaves within 1e-5. Returns the
    max abs errors of kernels 1, 2 and 4."""
    from repro_torch.core.coded_layer import make_parity_weights
    from repro_torch.core.coding import generator_matrix
    from repro_torch.kernels import cdc_encode as enc
    gen = torch.Generator(device="cuda").manual_seed(51)
    worst1, n1 = 0.0, 0
    for name, (k, m_l) in shapes["gemms"].items():
        for rows in (1, 4, 5, 16):
            spec, x, w, wc = _coded_case(m_l, rows, "folded", gen, k)
            for valid in _masks():
                got = _run_coded(x, w, wc, spec, valid)
                want = _run_coded(x, w, wc, spec, valid, plain=True)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, **TOL, msg=lambda m: (
                    f"{tag} {name} rows={rows} mask={valid}: {m}"))
                worst1, n1 = max(worst1, float((got - want).abs().max())), \
                    n1 + 1
            xi = _int_head((rows, k), gen, -2, 2)
            wi = _int_head((k, T * m_l), gen)
            wci = make_parity_weights(wi, spec)
            full = (True,) * T
            a = _run_coded(xi, wi, wci, spec, full)
            b = _run_coded(xi, wi, wci, spec, full)
            want = _run_coded(xi, wi, wci, spec, full, plain=True)
            torch.cuda.synchronize()
            if not (torch.equal(a, want) and torch.equal(a, b)):
                raise AssertionError(f"{tag} {name} rows={rows}: integer "
                                     f"inputs differ from the plain "
                                     f"version or between launches")
            n1 += 1
    # kernel 2 at the head
    k, m_l, vocab = shapes["head"]
    worst2, n2 = 0.0, 0
    w = (torch.randn((k, T * m_l), generator=gen, device="cuda")
         / k ** 0.5)
    w[:, vocab:] = 0.0
    w_shards, pw = _head_views(w)
    for rows in (1, 4, 5):
        x = torch.randn((rows, k), generator=gen, device="cuda")
        for valid in _masks():
            worst2 = max(worst2, _head_pair(x, w_shards, pw, valid,
                                            vocab)[1])
            n2 += 1
    wi = _int_head((k, T * m_l), gen)
    xi = _int_head((4, k), gen, 1, 2)
    wi[:, vocab:] = 16.0                   # the padded columns: masked
    tie = (10, 2 * m_l + 5000)             # shard 0 tile 0, shard 2 tile 19
    for gid in tie:
        wi[:, gid] = 8.0
    w_shards, pw = _head_views(wi)
    for valid in _masks():
        tok, err = _head_pair(xi, w_shards, pw, valid, vocab)
        if err != 0.0 or tok.tolist() != [min(tie)] * 4:
            raise AssertionError(f"{tag} head on exact inputs: tokens "
                                 f"{tok.tolist()} (want {min(tie)}), max "
                                 f"error {err} (mask {valid})")
        n2 += 1
    del w, wi, w_shards, pw
    # kernel 4 on the leaves
    worst4, n4 = 0.0, 0
    g = generator_matrix(T, R)
    for shape in shapes["encode"]:
        w = torch.randn(shape, generator=gen, device="cuda") / shape[-2] ** 0.5
        sh = _shards(w, T)
        got = enc.cdc_encode(sh, g, layout="folded")
        want = enc.encode_plain(sh, g, "folded")
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        worst4, n4 = max(worst4, float((got - want).abs().max())), n4 + 1
        del w, sh, got, want
    gemms = ", ".join(f"{n} (k {k}, m_l {m})"
                      for n, (k, m) in shapes["gemms"].items())
    log(f"{tag} widths: kernel cdc_coded_matmul {n1} cases ({gemms}; rows "
        f"1/4/5/16; every mask) within 1e-4 of the plain version (max abs "
        f"err {worst1:.3e}), integer inputs to the bit; kernel "
        f"cdc_fused_head_argmax {n2} cases (head k {shapes['head'][0]}, m_l "
        f"{m_l}, vocab {vocab}) within 1e-4 (max abs err {worst2:.3e}), "
        f"integer inputs to the bit, padded columns never returned, the "
        f"tie to id {min(tie)}; kernel cdc_encode {n4} leaves within 1e-5 "
        f"(max abs err {worst4:.3e})")
    return worst1, worst2, worst4


def check_whisper_kernels(cfg) -> tuple[float, float, float]:
    """``check_width_kernels`` at whisper-medium's widths (k = 1024; wq's
    64-column folded slices, w1; the head's 51865 words padded to 51872,
    m_l 12968, 51 tiles, 5 k splits)."""
    return check_width_kernels("whisper", whisper_shapes(cfg))


def check_xlstm_kernels(cfg) -> tuple[float, float, float]:
    """``check_width_kernels`` at xlstm-125m's widths (``xlstm_shapes``)."""
    return check_width_kernels("xlstm", xlstm_shapes(cfg))


def check_hymba_kernels(cfg) -> tuple[float, float, float]:
    """``check_width_kernels`` at hymba-1.5b's widths (``hymba_shapes``)."""
    return check_width_kernels("hymba", hymba_shapes(cfg))


def _phase_memory(name: str):
    log(f"{name}: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


# ------------------------------------------------------------ phase 3 ----

def norms_per_pass(cfg) -> int:
    """RMSNorm launches of one model pass (a decode round or a prefill):
    two per layer (an MoE layer's too) and the final norm. The
    encoder-decoder's norms are all LayerNorm (none); xLSTM's blocks use
    LayerNorm (its final norm only)."""
    if cfg.is_encdec:
        return 0
    return 1 if cfg.ssm_kind == "xlstm" else 2 * cfg.n_layers + 1


def coded_gemms(cfg) -> int:
    """Coded GEMMs of one decode round, one kernel-1 launch each in a
    fused round: wq, wk, wv, w1 and w3 of every layer (whisper: self wq,
    wk, wv, cross wq and w1; the hybrid adds the mamba branch's in_proj;
    an MoE's w1 and w3 are its shared experts', and without shared
    experts it has wq, wk and wv only: the routed experts are uncoded);
    xLSTM: up, wq, wk and wv of every mLSTM block and wx of every sLSTM
    block."""
    if cfg.n_experts:
        return (5 if cfg.n_shared_experts else 3) * cfg.n_layers
    if cfg.ssm_kind == "xlstm":
        from repro_torch.models.transformer import xlstm_block_kinds
        return sum(4 if k == "mlstm" else 1 for k in xlstm_block_kinds(cfg))
    return (6 if cfg.family == "hybrid" else 5) * cfg.n_layers


N_TOK = 16


def serve_batch(vocab: int) -> dict:
    """The served requests: 4 prompts of 16 tokens, seeded."""
    return {"tokens": np.random.default_rng(0).integers(0, vocab, (4, 16))}


def _serve_run(eng, batch, fail_at=None, n_tok: int = N_TOK) -> dict:
    """One ServingEngine.generate of the 4 requests (n_tok new tokens),
    with the launch counts of kernels 1, 2 and 6 read around it (a
    replayed graph's launches are credited to the counts) and VStep's
    round counters over the run."""
    from repro_torch.kernels import cdc_decode, cdc_matmul, rmsnorm
    counted = (cdc_matmul.cdc_coded_matmul,
               cdc_decode.cdc_fused_head_argmax, rmsnorm.rmsnorm)
    for fn in counted:
        fn.launches = 0
        fn.variants.clear()
    vs = eng.executor(4).vstep
    before = {k: getattr(vs, k) for k in VSTEP_COUNTERS}
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks = eng.generate(batch, n_tok, fail_at=fail_at)
    torch.cuda.synchronize()
    ex = eng.executor(4)
    out = {"tokens": toks, "seconds": time.perf_counter() - t,
           "round_ms": list(ex.round_ms[-(n_tok - 1):]),
           "variants": ex.vstep.last_variant, "graphs": vs.use_graphs,
           "vstep": {k: getattr(vs, k) - before[k]
                     for k in VSTEP_COUNTERS}}
    for key, fn in zip(("k1", "k2", "k6"), counted):
        out[key] = fn.launches
        out[f"{key}_variants"] = dict(fn.variants)
    return out


VSTEP_COUNTERS = ("n_dispatches", "n_fused_rounds", "n_captures",
                  "n_replays", "n_graph_drops")


def _check_graph_run(name: str, res: dict, captures: int):
    """A run on graph rounds: one replay per fused round, every round
    fused, and at most ``captures`` new graphs (one per new mask)."""
    c = res["vstep"]
    if not res["graphs"] or c["n_replays"] != c["n_fused_rounds"] \
            or c["n_fused_rounds"] != c["n_dispatches"] \
            or c["n_captures"] > captures:
        raise AssertionError(f"{name}: graph counters {c} (want a replay "
                             f"per fused round, <= {captures} captures)")


def _check_eager_run(name: str, res: dict):
    c = res["vstep"]
    if res["graphs"] or c["n_replays"] or c["n_captures"]:
        raise AssertionError(f"{name}: an eager run captured or replayed: "
                             f"{c}")


def serve_full_width(cfg) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.models import TPCtx, build, transformer
    from repro_torch.serve import ServeConfig, ServingEngine
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R))
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    log(f"granite-3-8b full width: params initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    scfg = ServeConfig(max_len=16 + 16 + 8, batch=4,
                       cache_dtype=torch.float32)
    batch = serve_batch(cfg.vocab)
    n_tok = N_TOK

    def run(eng, fail_at=None):
        return _serve_run(eng, batch, fail_at)

    torch.cuda.reset_peak_memory_stats()
    # fused rounds replay captured CUDA graphs (the default on the card)
    eng = ServingEngine(model, params, scfg, use_fused=True,
                        use_graphs=True)
    clean = run(eng)
    _check_graph_run("fault-free", clean, 1)
    graph_eager = graph_vs_eager(eng, batch, clean)
    overlapped = run_overlapped(eng.stepper, batch, n_tok)
    if not np.array_equal(overlapped["tokens"], clean["tokens"]):
        raise AssertionError("overlapped executor tokens differ:\n"
                             f"{overlapped['tokens']}\nvs\n{clean['tokens']}")
    faulty = run(eng, fail_at={4: 2})      # a second graph: shard 2 dead
    _check_graph_run("erasure", faulty, 1)
    eng.valid = np.ones(T, bool)
    eng.use_graphs = False
    faulty_eager = run(eng, fail_at={4: 2})
    _check_eager_run("eager erasure", faulty_eager)
    if not np.array_equal(faulty_eager["tokens"], faulty["tokens"]):
        raise AssertionError("eager and graph rounds differ with shard 2 "
                             f"erased:\n{faulty_eager['tokens']}\nvs\n"
                             f"{faulty['tokens']}")
    eng.use_graphs = True
    vs = eng.executor(4).vstep
    graph_counts = {k: getattr(vs, k) for k in VSTEP_COUNTERS}
    del eng, vs
    ref_eng = ServingEngine(model, params, scfg, use_fused=False)
    reference = run(ref_eng)
    # the same reference variant with the norms on their plain version (the
    # model resolves ``rmsnorm`` in the transformer module): a run with no
    # kernel at all, the oracle for the fused tokens
    norm = transformer.rmsnorm
    transformer.rmsnorm = lambda p, x, eps: ref.rmsnorm_ref(x, p["g"], eps)
    try:
        plain = run(ref_eng)
    finally:
        transformer.rmsnorm = norm
    del ref_eng
    peak = torch.cuda.max_memory_allocated()
    rounds = n_tok - 1
    gemms = 5 * cfg.n_layers          # wq, wk, wv, w1, w3 in every layer
    for name, res in (("fault-free", clean), ("shard 2 dead at step 4",
                                              faulty)):
        if res["k1"] != gemms * rounds or res["k2"] != rounds:
            raise AssertionError(
                f"{name}: {res['k1']} coded-GEMM and {res['k2']} head "
                f"launches over {rounds} fused rounds; expected "
                f"{gemms * rounds} and {rounds}")
    if reference["k1"] or reference["k2"]:
        raise AssertionError("the reference variant launched a kernel")
    # granite's GEMMs and head are aligned: every launch takes the copy
    # engine, and the head's 4 rows one block of 4 rows each
    for name, res in (("fault-free", clean), ("erasure", faulty)):
        if not all(v.endswith("-async") for v in res["k1_variants"]):
            raise AssertionError(f"{name}: coded-GEMM instantiations "
                                 f"{res['k1_variants']}; want only -async")
        if res["k2_variants"] != {"rb4-async": rounds}:
            raise AssertionError(f"{name}: fused-head instantiations "
                                 f"{res['k2_variants']}; want rb4-async "
                                 f"x {rounds}")
    if plain["k1"] or plain["k2"] or plain["k6"]:
        raise AssertionError(
            f"the kernel-free run launched {plain['k1']} coded-GEMM, "
            f"{plain['k2']} head and {plain['k6']} rmsnorm kernels")
    # every round and every prefill (one per request) runs its norms
    # through kernel 6, in the fused and the reference variant alike
    norms = norms_per_pass(cfg)
    for name, res in (("fault-free", clean), ("erasure", faulty),
                      ("reference", reference)):
        if res["k6"] != norms * (rounds + 4):
            raise AssertionError(
                f"{name}: {res['k6']} rmsnorm launches; expected {norms} "
                f"per round x {rounds} rounds + {norms} per prefill x 4")
    for name, res in (("erasure", faulty), ("reference", reference),
                      ("kernel-free", plain)):
        if not np.array_equal(res["tokens"], clean["tokens"]):
            raise AssertionError(
                f"{name} run tokens differ from the fault-free fused run:\n"
                f"{res['tokens']}\nvs\n{clean['tokens']}")
    toks = clean["tokens"]
    if toks.shape != (4, n_tok) or toks.min() < 0 or toks.max() >= cfg.vocab:
        raise AssertionError(f"bad token stream {toks}")
    med = float(np.median(clean["round_ms"]))
    log(f"served 4 requests x {n_tok} tokens: identical streams fault-free, "
        f"with shard 2 erased at step 4, on the reference variant, and on "
        f"it with plain norms (no kernel launched)")
    log("first stream:", toks[0].tolist())
    log(f"overlapped executor (dispatch N, then harvest N-1): same "
        f"streams, {overlapped['period_ms']:.3f} ms per round (wall time "
        f"of {n_tok} steps / {n_tok})")
    log(f"launches per fused round: {clean['k1'] // rounds} coded-GEMM "
        f"({clean['k1_variants']}) + "
        f"{clean['k2'] // rounds} fused head ({clean['k2_variants']}) + "
        f"{norms} rmsnorm ({clean['k6_variants']}; and {norms} rmsnorm per "
        f"prefill; the reference variant {norms} per round)")
    log(f"graph rounds: {graph_counts['n_captures']} captures (fault-free, "
        f"shard 2 dead), {graph_counts['n_replays']} replays for "
        f"{graph_counts['n_fused_rounds']} fused rounds; tokens equal to "
        f"eager fused rounds fault-free and with shard 2 erased")
    log(f"fused round median {med:.3f} ms (erasure run "
        f"{float(np.median(faulty['round_ms'])):.3f} ms, reference variant "
        f"{float(np.median(reference['round_ms'])):.3f} ms, with plain "
        f"norms {float(np.median(plain['round_ms'])):.3f} ms); "
        f"{4 * 1e3 / med:.1f} tokens/s at 4 slots; "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB")
    return {"k1": clean["k1"], "k2": clean["k2"], "k6": clean["k6"],
            "breakdown": graph_eager["breakdown"],
            "graph_vs_eager": graph_eager}


def graph_vs_eager(eng, batch, first: dict, blocks: int = 3) -> dict:
    """Round time of graph-replayed and eager fused rounds in alternating
    blocks (eager, graph, eager, graph, ...; ``first``, a graph run, is
    the first graph block), each block one generate of the 4 requests with
    tokens identical to ``first``'s; then the profiler's device time over
    3 more rounds of each. Leaves the engine on graph rounds."""
    runs = {True: [first], False: []}
    for i in range(2 * blocks - 1):
        eng.use_graphs = i % 2 == 1
        res = _serve_run(eng, batch)
        if eng.use_graphs:
            _check_graph_run(f"block {i + 1}", res, 0)
        else:
            _check_eager_run(f"block {i + 1}", res)
        if not np.array_equal(res["tokens"], first["tokens"]):
            raise AssertionError(f"{'graph' if eng.use_graphs else 'eager'}"
                                 f" block {i + 1} tokens differ:\n"
                                 f"{res['tokens']}\nvs\n{first['tokens']}")
        runs[eng.use_graphs].append(res)
    out = {}
    for graphs, name in ((False, "eager"), (True, "graph")):
        eng.use_graphs = graphs
        ms = [x for r in runs[graphs] for x in r["round_ms"]]
        med = float(np.median(ms))
        log(f"{name} fused rounds ({len(runs[graphs])} blocks, {len(ms)} "
            f"rounds): median {med:.3f} ms, block medians "
            f"{[round(float(np.median(r['round_ms'])), 3) for r in runs[graphs]]}")
        prof = profile_rounds(eng.executor(4), eng.valid, med)
        out[name] = {"round_ms_median": med, "rounds": len(ms),
                     "block_medians": [float(np.median(r["round_ms"]))
                                       for r in runs[graphs]],
                     "device_ms": prof.get("device_ms"),
                     "idle_share": (1 - prof["device_ms"] / med
                                    if prof else None),
                     "profile": prof}
    out["breakdown"] = out["eager"]["profile"]
    log(f"graph vs eager (same call, alternating blocks): round median "
        f"{out['graph']['round_ms_median']:.3f} vs "
        f"{out['eager']['round_ms_median']:.3f} ms, device busy "
        f"{out['graph']['device_ms']} vs {out['eager']['device_ms']} ms, "
        f"idle share {out['graph']['idle_share']} vs "
        f"{out['eager']['idle_share']}")
    return out


def run_overlapped(stepper, batch, n_tok: int) -> dict:
    """The same requests through a pipelined executor (overlap=True): each
    step dispatches round N and harvests round N-1 through its pinned
    host copy and CUDA event."""
    from repro_torch.runtime.executor import SlotPoolExecutor
    ex = SlotPoolExecutor(stepper, 4, overlap=True, use_fused=True)
    valid = np.ones(T, bool)
    toks = np.zeros((4, n_tok), np.int64)
    filled = [1] * 4
    for i in range(4):
        toks[i, 0] = ex.admit(i, batch["tokens"][i], valid, tag=i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_tok):          # the last step only drains the pipe
        for slot, tag, tok in ex.step_round(valid):
            if filled[slot] < n_tok:
                toks[slot, filled[slot]] = tok
                filled[slot] += 1
    ex.drop_pending()
    torch.cuda.synchronize()
    return {"tokens": toks,
            "period_ms": (time.perf_counter() - t0) * 1e3 / n_tok}


def profile_rounds(ex, valid, round_ms: float, n: int = 3) -> dict:
    """Device time of ``n`` more fused rounds by kernel, from
    torch.profiler, against the unprofiled median round time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            ex.step_round(valid)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count // n)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms == 0:
        log("profiler: no device time recorded; breakdown not measured")
        return {}
    log(f"profiler, per fused round: device busy {device_ms:.3f} ms of a "
        f"{round_ms:.3f} ms round (idle share "
        f"{1 - device_ms / round_ms:.3f}); by kernel:")
    for key, ms, count in rows[:10]:
        log(f"  {ms:8.3f} ms  x{count:<4d} {key[:90]}")
    per_launch = {name: (ms, count) for key, ms, count in rows
                  for name in ("rmsnorm_kernel", "head_stream_kernel")
                  if name in key}
    for name, (ms, count) in per_launch.items():
        log(f"  {name}: {ms * 1e3 / max(count, 1):.3f} us a launch "
            f"({count} a round)")
    return {"device_ms": device_ms, "round_ms": round_ms,
            "top": [{"kernel": k[:90], "ms": ms, "count": c}
                    for k, ms, c in rows[:10]],
            "by_kernel": {k: {"ms": ms, "count": c} for k, ms, c in rows},
            "us_per_launch": {n: ms * 1e3 / max(c, 1)
                              for n, (ms, c) in per_launch.items()}}


# ------------------------------------------------------------ phase 4 ----

def _time(fn, flush, n=30) -> float:
    """Median device ms of ``fn`` over n calls, each timed by CUDA events.
    Before each call ``flush`` evicts the weights from L2 (the main path
    finds them cold), and a spin kernel holds the stream while the host
    enqueues the call, so the events time the device work and not the
    host's launch overhead."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _profile_us(fn, name: str, n: int = 200) -> float:
    """Device microseconds a call of ``fn`` spends in the kernels whose
    name holds ``name`` (every kernel for ""), by torch.profiler over n
    calls, back to back, the inputs left where the last call left them."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and name in e.key)
    if not us:
        raise AssertionError(f"the profiler recorded no device time for "
                             f"{name!r}")
    return us / n


def _bound(bytes_moved: float, flops: float,
           peak: float = F32_FLOPS) -> tuple[float, str]:
    t_b, t_o = bytes_moved / HBM_BYTES_PER_S, flops / peak
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


PTXAS: dict[str, str] = {}     # kernel entry -> ptxas usage (phase 1)


def _usage(entry: str, rb: int | None = None) -> str:
    """ptxas's registers and static shared memory of the first kernel
    entry containing ``entry``, and, for a streaming kernel with ``rb``
    rows a block, its dynamic shared memory (stream_tile.cuh's Geo<RB>:
    the ring, the staged activations, the row statistics, the barriers)."""
    line = next((v for k, v in PTXAS.items() if entry in k),
                "ptxas usage not recorded (kernels not rebuilt)")
    if rb is not None:
        from repro_torch.kernels import stream_plan as sp
        dyn = (sp.NSTAGE[rb] * sp.STAGE_FLOATS + sp.XS_FLOATS[rb] + 16) * 4 \
            + 2 * sp.NSTAGE[rb] * 8
        line += f", {dyn} bytes dynamic smem"
    return line


def time_kernels(cfg, rows: int = 4) -> list[dict]:
    from repro_torch.core.coded_layer import unfold_parity
    from repro_torch.kernels import cdc_decode, cdc_matmul, ref
    gen = torch.Generator(device="cuda").manual_seed(13)
    scratch = torch.empty(64 * 2 ** 20, device="cuda")   # 256 MB > L2
    flush = scratch.zero_
    out = []
    # r=2 is the main path's geometry; w1 at r=4 is the planner's; 64 rows
    # is a prefill's
    for rws, name, m_l, r in [(rw, n, m, rr) for rw in (rows, 64)
                              for n, m, rr in (("w1", 3200, R),
                                               ("wq", 1024, R),
                                               ("wk", 256, R),
                                               ("w1", 3200, 4))]:
        spec, x, w, wc = _coded_case(m_l, rws, "folded", gen, r=r)
        valid = (True,) * T
        wcat = torch.cat([w, unfold_parity(wc, T, r).permute(1, 0, 2)
                          .reshape(K, r * m_l)], dim=1)
        cdc_matmul.cdc_coded_matmul.variants.clear()
        ms = _time(lambda: _run_coded(x, w, wc, spec, valid), flush)
        if not out:
            # the phase's first reading ran ~12% above kernel_times.py's
            # at the same shape: timed again, both logged
            first, ms = ms, _time(lambda: _run_coded(x, w, wc, spec, valid),
                                  flush)
            log(f"cdc_coded_matmul {name} [rows={rws}, T={T}, r={r}]: the "
                f"phase's first reading {first:.4f} ms, then {ms:.4f} ms")
        variant, = cdc_matmul.cdc_coded_matmul.variants
        plain = _time(lambda: _run_coded(x, w, wc, spec, valid, plain=True),
                      flush)
        lib = _time(lambda: torch.matmul(x, wcat), flush)
        nbytes = 4 * (rws * K + (T + r) * K * m_l + rws * T * m_l
                      + 2 * m_l)
        bound, by = _bound(nbytes, 2.0 * rws * K * m_l * (T + r))
        rb = int(variant.split("-")[0][2:])
        usage = _usage(f"coded_stream_kernelILi{T}ELi{r}ELi1ELi{rb}ELb"
                       f"{int(variant.endswith('async'))}E", rb)
        out.append({"gemm": name, "r": r, "rows": rws, "m_l": m_l,
                    "ms": ms, "plain_ms": plain, "library_ms": lib,
                    "bound_ms": bound, "bound_by": by, "variant": variant,
                    "ptxas": usage})
        log(f"cdc_coded_matmul {name} [rows={rws}, k={K}, m_l={m_l}, "
            f"T={T}, r={r}]: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"library matmul {lib:.4f} ms, bound {bound:.4f} ms ({by}); "
            f"{variant}: {usage}")
        del x, w, wc, wcat
    w = _head(cfg, gen)
    w_shards, pw = _head_views(w)
    m_l = w_shards.shape[2]
    wcat = torch.cat([w, pw], dim=1)
    valid = (True,) * T
    vt = torch.tensor(valid)
    # the decode round's rows, and 16 (four times the slots)
    for rws in (rows, 16):
        x = torch.randn((rws, K), generator=gen, device="cuda")
        cdc_decode.cdc_fused_head_argmax.variants.clear()
        ms = _time(lambda: cdc_decode.cdc_fused_head_argmax(
            x, w_shards, pw, valid, vocab=cfg.vocab), flush)
        variant, = cdc_decode.cdc_fused_head_argmax.variants
        plain = _time(lambda: ref.fused_head_argmax_ref(x, w_shards, pw, vt,
                                                        cfg.vocab), flush)
        lib = _time(lambda: torch.matmul(x, wcat), flush)
        nbytes = 4 * (rws * K + (T + 1) * K * m_l + 2 * rws)
        bound, by = _bound(nbytes, 2.0 * rws * K * m_l * (T + 1))
        rb = int(variant.split("-")[0][2:])
        usage = _usage(f"head_stream_kernelILi{T}ELi{rb}ELb"
                       f"{int(variant.endswith('async'))}E", rb)
        out.append({"gemm": "lm_head", "rows": rws, "m_l": m_l, "ms": ms,
                    "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                    "bound_by": by, "variant": variant, "ptxas": usage})
        log(f"cdc_fused_head_argmax [b={rws}, k={K}, m_l={m_l}]: kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, library matmul {lib:.4f} "
            f"ms, bound {bound:.4f} ms ({by}); {variant}: {usage}")
    del w, w_shards, pw, wcat
    out += time_wide_and_bf16(cfg, gen, flush, rows)
    out += time_small_kernels(gen, flush)
    return out


def time_width_kernels(tag: str, shapes: dict, rows: int = 4
                       ) -> list[dict]:
    """Kernels 1 and 2 at one model's decode-round shapes (``shapes`` as
    ``whisper_shapes`` gives them; T = 4, r = 2 folded, 4 rows): kernel 1
    at each GEMM, kernel 2 at the head, beside their plain versions, one
    torch.matmul of x over the same weights (concatenated) and their
    bounds, each logged beside the card's name and power limit."""
    from repro_torch.core.coded_layer import unfold_parity
    from repro_torch.kernels import cdc_decode, cdc_matmul, ref
    gen = torch.Generator(device="cuda").manual_seed(53)
    scratch = torch.empty(64 * 2 ** 20, device="cuda")   # 256 MB > L2
    flush = scratch.zero_
    card = card_line()
    out = []
    for name, (k, m_l) in shapes["gemms"].items():
        spec, x, w, wc = _coded_case(m_l, rows, "folded", gen, k)
        valid = (True,) * T
        wcat = torch.cat([w, unfold_parity(wc, T, R).permute(1, 0, 2)
                          .reshape(k, R * m_l)], dim=1)
        cdc_matmul.cdc_coded_matmul.variants.clear()
        ms = _time(lambda: _run_coded(x, w, wc, spec, valid), flush)
        variant, = cdc_matmul.cdc_coded_matmul.variants
        plain = _time(lambda: _run_coded(x, w, wc, spec, valid, plain=True),
                      flush)
        lib = _time(lambda: torch.matmul(x, wcat), flush)
        nbytes = 4 * (rows * k + (T + R) * k * m_l + rows * T * m_l)
        bound, by = _bound(nbytes, 2.0 * rows * k * m_l * (T + R))
        out.append({"gemm": f"{tag} {name}", "r": R, "rows": rows,
                    "k": k, "m_l": m_l, "ms": ms, "plain_ms": plain,
                    "library_ms": lib, "bound_ms": bound, "bound_by": by,
                    "variant": variant})
        log(f"cdc_coded_matmul {tag} {name} [rows={rows}, k={k}, "
            f"m_l={m_l}, T={T}, r={R}]: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, library matmul {lib:.4f} ms, bound "
            f"{bound:.4f} ms ({by}); {variant}; {card}")
        del x, w, wc, wcat
    k, m_l, vocab = shapes["head"]
    w = torch.randn((k, T * m_l), generator=gen, device="cuda") / k ** 0.5
    w[:, vocab:] = 0.0
    w_shards, pw = _head_views(w)
    wcat = torch.cat([w, pw], dim=1)
    valid = (True,) * T
    x = torch.randn((rows, k), generator=gen, device="cuda")
    cdc_decode.cdc_fused_head_argmax.variants.clear()
    ms = _time(lambda: cdc_decode.cdc_fused_head_argmax(
        x, w_shards, pw, valid, vocab=vocab), flush)
    variant, = cdc_decode.cdc_fused_head_argmax.variants
    plain = _time(lambda: ref.fused_head_argmax_ref(
        x, w_shards, pw, torch.tensor(valid), vocab), flush)
    lib = _time(lambda: torch.matmul(x, wcat), flush)
    nbytes = 4 * (rows * k + (T + 1) * k * m_l + 2 * rows)
    bound, by = _bound(nbytes, 2.0 * rows * k * m_l * (T + 1))
    out.append({"gemm": f"{tag} lm_head", "rows": rows, "k": k, "m_l": m_l,
                "ms": ms, "plain_ms": plain, "library_ms": lib,
                "bound_ms": bound, "bound_by": by, "variant": variant})
    log(f"cdc_fused_head_argmax {tag} [b={rows}, k={k}, m_l={m_l}]: "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library matmul "
        f"{lib:.4f} ms, bound {bound:.4f} ms ({by}); {variant}; {card}")
    return out


def time_whisper(cfg, rows: int = 4) -> list[dict]:
    """``time_width_kernels`` at whisper-medium's widths: kernel 1 at wq
    and w1 (k = 1024), kernel 2 at the head (m_l 12968)."""
    return time_width_kernels("whisper", whisper_shapes(cfg), rows)


def time_xlstm(cfg, rows: int = 4) -> list[dict]:
    """``time_width_kernels`` at xlstm-125m's widths: kernel 1 at up (k
    768, m_l 768) and wq (k 1536, m_l 384), kernel 2 at the head (k 768,
    m_l 12576)."""
    return time_width_kernels("xlstm", xlstm_shapes(cfg), rows)


def time_hymba(cfg, rows: int = 4) -> list[dict]:
    """``time_width_kernels`` at hymba-1.5b's widths: kernel 1 at wk (m_l
    112), in_proj (800) and w1 (1376), k 1600; kernel 2 at the head (k
    1600, m_l 8004)."""
    return time_width_kernels("hymba", hymba_shapes(cfg), rows)


def time_wide_and_bf16(cfg, gen, flush, rows: int = 4) -> list[dict]:
    """Kernels 1 and 2 on bf16 storage at T = 4 and in float32 at T = 16,
    at the decode round's rows: kernel 1 at granite's w1 (r = 2 and 4), wq
    and wk (r = 2), folded (``kernel_times.WIDE_AND_BF16``, the shapes
    ``kernel_times.py --new`` times), kernel 2 at its head; beside their
    plain versions and one torch.matmul of x over the same weights,
    concatenated, in their storage type. Bounds: the bytes in their
    storage type, or the FLOPs at the type's peak (bf16: the tensor
    cores')."""
    from kernel_times import WIDE_AND_BF16
    from repro_torch.core.coded_layer import unfold_parity
    from repro_torch.kernels import cdc_decode, cdc_matmul, ref
    from repro_torch.models.common import TPCtx
    out = []
    for t, dtype, gemms in WIDE_AND_BF16:
        e = 2 if dtype == torch.bfloat16 else 4
        peak = BF16_FLOPS if e == 2 else F32_FLOPS
        tag = f"T={t} {str(dtype).split('.')[-1]}"
        for name, width, r in gemms:
            m_l = width // t
            spec, x, w, wc = _coded_case(m_l, rows, "folded", gen, r=r, t=t,
                                         dtype=dtype)
            valid = (True,) * t
            wcat = torch.cat([w, unfold_parity(wc, t, r).permute(1, 0, 2)
                              .reshape(K, r * m_l)], dim=1)
            cdc_matmul.cdc_coded_matmul.variants.clear()
            ms = _time(lambda: _run_coded(x, w, wc, spec, valid), flush)
            variant, = cdc_matmul.cdc_coded_matmul.variants
            plain = _time(lambda: _run_coded(x, w, wc, spec, valid,
                                             plain=True), flush)
            lib = _time(lambda: torch.matmul(x, wcat), flush)
            bound, by = _bound(e * (rows * K + (t + r) * K * m_l
                                    + rows * t * m_l) + 8.0 * m_l,
                               2.0 * rows * K * m_l * (t + r), peak)
            out.append({"gemm": name, "r": r, "rows": rows, "m_l": m_l,
                        "case": tag, "ms": ms, "plain_ms": plain,
                        "library_ms": lib, "bound_ms": bound,
                        "bound_by": by, "variant": variant})
            log(f"cdc_coded_matmul {name} {tag} [rows={rows}, k={K}, "
                f"m_l={m_l}, r={r} folded]: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, library matmul {lib:.4f} ms, bound "
                f"{bound:.4f} ms ({by}); {variant}")
            del x, w, wc, wcat
        m = TPCtx(tp=t).pad_dim(cfg.vocab)
        w = (torch.randn((K, m), generator=gen, device="cuda")
             / K ** 0.5).to(dtype)
        w_shards, pw = _head_views(w, t)
        m_l = w_shards.shape[2]
        wcat = torch.cat([w, pw], dim=1)
        x = torch.randn((rows, K), generator=gen, device="cuda")
        vt = torch.tensor((True,) * t)
        cdc_decode.cdc_fused_head_argmax.variants.clear()
        ms = _time(lambda: cdc_decode.cdc_fused_head_argmax(
            x, w_shards, pw, (True,) * t, vocab=cfg.vocab), flush)
        variant, = cdc_decode.cdc_fused_head_argmax.variants
        plain = _time(lambda: ref.fused_head_argmax_ref(
            x, w_shards, pw, vt, cfg.vocab), flush)
        xl = x.to(dtype)
        lib = _time(lambda: torch.matmul(xl, wcat), flush)
        bound, by = _bound(4.0 * rows * K + e * (t + 1) * K * m_l
                           + 8.0 * rows, 2.0 * rows * K * m_l * (t + 1),
                           peak)
        out.append({"gemm": "lm_head", "rows": rows, "m_l": m_l,
                    "case": tag, "ms": ms, "plain_ms": plain,
                    "library_ms": lib, "bound_ms": bound, "bound_by": by,
                    "variant": variant})
        log(f"cdc_fused_head_argmax {tag} [b={rows}, k={K}, m_l={m_l}]: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library matmul "
            f"{lib:.4f} ms, bound {bound:.4f} ms ({by}); {variant}")
        del w, w_shards, pw, wcat
    return out


def time_rowcopy(rows: int = 4) -> list[dict]:
    """Kernel 1's row-copy instantiation at the shapes only it takes
    (``kernel_times.ROWCOPY_TIMED``: T = 12's w1, bf16 and odd r at T =
    16; folded, no shard dead), beside its plain version, one torch.matmul
    of x over the same weights (concatenated, in their storage type) and
    its bound. T = 12's w1 is also ``time_t12``'s row; it is timed here
    again beside the other shapes of the same instantiation."""
    from kernel_times import ROWCOPY_TIMED
    from repro_torch.core.coded_layer import unfold_parity
    from repro_torch.kernels import cdc_matmul
    gen = torch.Generator(device="cuda").manual_seed(46)
    flush = torch.empty(64 * 2 ** 20, device="cuda").zero_
    out = []
    for t, dtype, name, width, r in ROWCOPY_TIMED:
        m_l = width // t
        e = 2 if dtype == torch.bfloat16 else 4
        peak = BF16_FLOPS if e == 2 else F32_FLOPS
        tag = f"T={t} {str(dtype).split('.')[-1]}"
        spec, x, w, wc = _coded_case(m_l, rows, "folded", gen, r=r, t=t,
                                     dtype=dtype)
        valid = (True,) * t
        wcat = torch.cat([w, unfold_parity(wc, t, r).permute(1, 0, 2)
                          .reshape(K, r * m_l)], dim=1)
        cdc_matmul.cdc_coded_matmul.variants.clear()
        ms = _time(lambda: _run_coded(x, w, wc, spec, valid), flush)
        variant, = cdc_matmul.cdc_coded_matmul.variants
        plain = _time(lambda: _run_coded(x, w, wc, spec, valid, plain=True),
                      flush)
        lib = _time(lambda: torch.matmul(x, wcat), flush)
        bound, by = _bound(e * (rows * K + (t + r) * K * m_l
                                + rows * t * m_l) + 8.0 * m_l,
                           2.0 * rows * K * m_l * (t + r), peak)
        out.append({"gemm": name, "r": r, "rows": rows, "m_l": m_l,
                    "case": tag, "ms": ms, "plain_ms": plain,
                    "library_ms": lib, "bound_ms": bound, "bound_by": by,
                    "variant": variant})
        log(f"cdc_coded_matmul {name} {tag} [rows={rows}, k={K}, m_l={m_l}, "
            f"r={r} folded]: kernel {ms:.4f} ms ({ms / bound:.2f}x the "
            f"bound), plain {plain:.4f} ms, library matmul {lib:.4f} ms, "
            f"bound {bound:.4f} ms ({by}); {variant}")
        del x, w, wc, wcat
    return out


def _row(out: list, kernel: str, shape: str, ms: float, plain: float,
         lib: float | None, nbytes: float, flops: float):
    bound, by = _bound(nbytes, flops)
    out.append({"kernel": kernel, "shape": shape, "ms": ms,
                "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                "bound_by": by})
    log(f"{kernel} {shape}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"library {'none' if lib is None else f'{lib:.4f} ms'}, bound "
        f"{bound:.4f} ms ({by})")


def time_small_kernels(gen, flush) -> list[dict]:
    """Kernels 3, 5, 6 and 7 at the shapes of their paths: the decode +
    merge at granite w1 (T=4, r=2 folded, shard 2 dead), the r=1 decode
    at the study's shape and at w1's, the norm at the serving round's 4
    and a prefill's 64 rows, the GEMM at the study's 512^3 and at
    granite's Wo with 4 rows. Bounds count the bytes these inputs need:
    the decodes read the live shards and the one selected parity (kernel
    3) or every shard and the parity (kernel 5)."""
    import torch.nn.functional as F
    from repro_torch.core.coded_layer import CodedDenseSpec
    from repro_torch.core.coding import CodeSpec
    from repro_torch.kernels import (cdc_decode, cdc_matmul, matmul, ref,
                                     rmsnorm)
    out: list[dict] = []
    spec = CodedDenseSpec(CodeSpec(T, R))
    m_l = GEMMS["w1"]
    dead2 = (True, True, False, True)
    floor_us = _profile_us(lambda: torch.cuda._sleep(0), "")
    log(f"an empty kernel (torch.cuda._sleep(0)): {floor_us:.3f} us of "
        f"device time a launch by the profiler (the launch floor)")
    for rows, valid in ((4, dead2), (64, dead2), (2048, dead2),
                        (2048, (True,) * T)):
        vh, esel, coef, g = _dm_plan(spec, valid, m_l)
        ys = torch.randn((T, rows, m_l), generator=gen, device="cuda")
        par = torch.randn((T, rows, R * m_l // T), generator=gen,
                          device="cuda")
        call = (ys, par, "folded", T, R, g, esel, coef, vh)
        ms = _time(lambda: cdc_matmul.cdc_decode_merge(*call), flush)
        plain = _time(lambda: cdc_matmul.decode_merge_plain(*call), flush)
        dead = not all(valid)
        _row(out, "cdc_decode_merge", f"[{T}, {rows}, {m_l}] r={R} folded"
             + ("" if dead else " all valid"), ms, plain, None,
             4.0 * (2 * T * rows * m_l) + (8.0 * m_l if dead else 0.0),
             rows * m_l * (2.0 * T + 2) if dead else 0.0)
        out[-1].update(profiler_us=_profile_us(
            lambda: cdc_matmul.cdc_decode_merge(*call), "decode_merge"),
            floor_us=floor_us)
        del ys, par
    for t, shape in ((8, (256, 512)), (4, (4, 3200)), (4, (2048, 3200))):
        y = torch.randn((t,) + shape, generator=gen, device="cuda")
        p = y.sum(0)
        valid = tuple(i != t // 2 for i in range(t))
        vt = torch.tensor(valid, device="cuda")
        n = p.numel()
        ms = _time(lambda: cdc_decode.cdc_decode(y, p, valid), flush)
        plain = _time(lambda: ref.cdc_decode_ref(y, p, vt), flush)
        _row(out, "cdc_decode", str([t, *shape]), ms, plain, None,
             4.0 * (2 * t + 1) * n, n * (3.0 * t + 1))
        out[-1].update(profiler_us=_profile_us(
            lambda: cdc_decode.cdc_decode(y, p, valid), "decode_kernel"),
            floor_us=floor_us)
        del y, p
    for row in out:
        log(f"  {row['kernel']} {row['shape']}: {row['profiler_us']:.3f} us "
            f"a launch by the profiler (bound {row['bound_ms'] * 1e3:.3f} "
            f"us, {row['bound_ms'] * 1e3 / row['profiler_us']:.0%} of it; "
            f"floor {floor_us:.3f} us)")
    gam = 1.0 + 0.1 * torch.randn(K, generator=gen, device="cuda")
    for rows in (4, 64):
        x = torch.randn((rows, K), generator=gen, device="cuda")
        rmsnorm.rmsnorm.variants.clear()
        ms = _time(lambda: rmsnorm.rmsnorm(x, gam, eps=1e-5), flush)
        variant, = rmsnorm.rmsnorm.variants
        plain = _time(lambda: ref.rmsnorm_ref(x, gam, 1e-5), flush)
        lib = _time(lambda: F.rms_norm(x, (K,), gam, 1e-5), flush)
        _row(out, "rmsnorm", f"[{rows}, {K}]", ms, plain, lib,
             4.0 * (2 * rows * K + K), 4.0 * rows * K)
        nv = 0 if variant == "scalar" else int(variant[2:])
        usage = _usage(f"rmsnorm_kernelIfLi{nv}EE")
        out[-1].update(variant=variant, ptxas=usage)
        log(f"  rmsnorm {variant}: {usage}")
    for m, k, n in ((512, 512, 512), (4, K, K)):
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
        matmul.matmul.variants.clear()
        ms = _time(lambda: matmul.matmul(x, w), flush)
        variant, = matmul.matmul.variants
        plain = _time(lambda: ref.matmul_ref(x, w), flush)
        lib = _time(lambda: torch.matmul(x, w), flush)
        a = int(variant.endswith("async"))
        rb = None if variant.startswith("square") else \
            int(variant.split("-")[1][2:])
        usage = (_usage(f"matmul_square_kernelIffLb{a}E") if rb is None else
                 _usage(f"matmul_rows_kernelILi{rb}EfLb{a}E", rb))
        _row(out, "matmul", f"[{m}, {k}] @ [{k}, {n}]", ms, plain, lib,
             4.0 * (m * k + k * n + m * n), 2.0 * m * k * n)
        out[-1].update(variant=variant, ptxas=usage)
        log(f"  matmul {variant}: {usage}")
    return out


# ------------------------------------------------------- phase 6 ----

def run_study(device: str = "cuda") -> dict:
    """The paper's coded-cost study through its port
    (``launch.coded_overhead``), at the reference's defaults: ``run``
    (T in {4, 8, 16} x r in {1, 2} folded, the encode kernel at T = 16
    included) and ``run_kernels`` (kernels 5 and 7). The counts are read
    around the two calls. The coded outputs are checked against x @ w:
    exact to 1e-4 with every shard alive, and with shard 1 dead at r = 2;
    at r = 1 folded (no device failure in budget) the 'recovering' output
    is beyond the budget, in this port as in the reference, and only its
    distance from x @ w is reported."""
    from repro_torch.launch import coded_overhead as study
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    wrappers["matmul"].variants.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = study.run(device=device)
    krows = study.run_kernels(device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    for name in ("cdc_decode", "matmul", "cdc_encode"):
        if not launches[name]:
            raise AssertionError(f"the study launched no {name}: {launches}")
    mm_variants = dict(wrappers["matmul"].variants)
    if set(mm_variants) != {"square-async"}:
        raise AssertionError(f"the study's 512^3 GEMM took {mm_variants}")
    if [(r["T"], r["r"]) for r in rows] != [(t, r) for t in (4, 8, 16)
                                            for r in (1, 2)]:
        raise AssertionError(f"study sweep {rows}")
    errs = {}
    for c in study.study_cases(device=device):
        exact = c.x @ c.w
        coded = float((c.coded(c.x) - exact).abs().max())
        rec = float((c.recovering(c.x) - exact).abs().max())
        if coded > 1e-4 or (c.r == 2 and rec > 1e-4):
            raise AssertionError(f"study T={c.T} r={c.r}: coded err {coded}"
                                 f", recovering err {rec}")
        errs[f"T={c.T},r={c.r}"] = {"coded": coded, "recovering": rec}
    log(f"coded-overhead study on the card ({secs:.1f} s, launches "
        f"{launches}; GEMM instantiations {mm_variants}):")
    for r in rows + krows:
        log(f"  {r}")
    log("  max |out - x @ w|: " + "; ".join(
        f"{k} coded {v['coded']:.2e} recovering {v['recovering']:.2e}"
        for k, v in errs.items()) + " (r=1 folded with shard 1 dead is "
        "beyond the budget)")
    return {"run": rows, "kernels": krows, "launches": launches,
            "errors": errs}


def decode_merge_entry(t: int = T) -> dict:
    """``core.decode_and_merge(use_fused=True)``, kernel 3's library entry,
    on a coded GEMM's own shard and parity outputs at granite's w1 and wq
    widths at code width t (4 rows, r=2 folded), each shard dead in turn
    with NaN outputs: it must rebuild x @ w, equal the reference
    decode_and_merge to 1e-5 and launch kernel 3 once per call."""
    from repro_torch.core.coded_layer import decode_and_merge
    from repro_torch.kernels import cdc_matmul
    gen = torch.Generator(device="cuda").manual_seed(21)
    cdc_matmul.cdc_decode_merge.launches = 0
    n, worst = 0, 0.0
    widths = granite_widths(t)
    for m_l in (widths["w1"], widths["wq"]):
        spec, x, w, wc = _coded_case(m_l, 4, "folded", gen, t=t)
        exact = x @ w
        ys = exact.reshape(4, t, m_l).movedim(1, 0).contiguous()
        par = torch.matmul(x[None], wc)
        for valid in _masks(t):
            yd = ys.clone()
            for d in range(t):
                if not valid[d]:
                    yd[d] = float("nan")
            v = np.array(valid)
            got = decode_and_merge(yd, par, spec, v, use_fused=True)
            want = decode_and_merge(yd, par, spec, v)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(got, exact, rtol=1e-4, atol=1e-4)
            worst = max(worst, float((got - want).abs().max()))
            n += 1
    launches = cdc_matmul.cdc_decode_merge.launches
    if launches != n:
        raise AssertionError(f"{launches} decode-merge launches for {n} "
                             f"calls of decode_and_merge(use_fused=True)")
    log(f"decode_and_merge(use_fused=True) at T = {t}: {n} calls (w1, "
        f"wq; every single dead shard) launched kernel 3 {launches} times, "
        f"equal to "
        f"the reference decode_and_merge within 1e-5 (max abs err "
        f"{worst:.3e}) and to x @ w within 1e-4")
    return {"launches": launches, "max_abs_err": worst}


def decode_entry(t: int = 12) -> dict:
    """``ops.cdc_decode``, kernel 5's library entry (the r = 1 decode), on
    a GEMM's own shard outputs at granite's w1 width at code width t (4
    rows) with their sum parity, each shard dead in turn (its outputs
    garbage: the decode zeroes a dead shard by multiplying): it must
    rebuild x @ w within 1e-4, equal the plain version within 1e-5 and
    launch kernel 5 once per call."""
    from repro_torch.kernels import cdc_decode, ops, ref
    gen = torch.Generator(device="cuda").manual_seed(45)
    cdc_decode.cdc_decode.launches = 0
    m_l = granite_widths(t)["w1"]
    x = torch.randn((4, K), generator=gen, device="cuda")
    w = torch.randn((K, t * m_l), generator=gen, device="cuda") / K ** 0.5
    ys = (x @ w).reshape(4, t, m_l).movedim(1, 0).contiguous()
    par = ys.sum(0)
    n, worst = 0, 0.0
    for valid in _masks(t):
        yd = ys.clone()
        for d in range(t):
            if not valid[d]:
                yd[d] = torch.randn((4, m_l), generator=gen, device="cuda")
        got = ops.cdc_decode(yd, par, valid)
        want = ref.cdc_decode_ref(yd, par, torch.tensor(valid))
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got, ys, rtol=1e-4, atol=1e-4)
        worst, n = max(worst, float((got - want).abs().max())), n + 1
    launches = cdc_decode.cdc_decode.launches
    if launches != n:
        raise AssertionError(f"{launches} decode launches for {n} calls of "
                             f"ops.cdc_decode")
    log(f"ops.cdc_decode at T = {t}: {n} calls (w1; every single dead "
        f"shard) launched kernel 5 {launches} times, equal to the plain "
        f"version within 1e-5 (max abs err {worst:.3e}) and to the shards "
        f"of x @ w within 1e-4")
    return {"launches": launches, "max_abs_err": worst}


# ------------------------------------------------------- phases 8, 9 ----

def _check_launches(name: str, res: dict, cfg, rounds: int, norms: bool):
    """Every fused round: kernel 1 for every coded GEMM (``coded_gemms``),
    kernel 2 once; with ``norms``, kernel 6 for every round and prefill."""
    gemms = coded_gemms(cfg)
    if res["k1"] != gemms * rounds or res["k2"] != rounds:
        raise AssertionError(f"{name}: {res['k1']} coded-GEMM and "
                             f"{res['k2']} head launches over {rounds} fused "
                             f"rounds; expected {gemms * rounds} and "
                             f"{rounds}")
    if norms and res["k6"] != norms_per_pass(cfg) * (rounds + 4):
        raise AssertionError(f"{name}: {res['k6']} rmsnorm launches")


def serve_t16(cfg) -> dict:
    """granite-3-8b at full width at T = 16 (what ``launch.serve --coded
    --tp 16`` builds: float32, r = 2 folded; 32/8 heads need no padding)
    through ServingEngine.generate, 4 requests, prompt 16, 16 new tokens:
    fused rounds fault-free and with shard 5 killed at step 4, and the
    reference variant; the three token streams must be identical. Every
    fused round launches kernel 1 200 times (all on the copy engine: wq's
    16-column slices and wk, wv's 4-column ones in boxes of their tile, w1
    and w3's 50-column ones in boxes a vector wider) and kernel 2 once."""
    from repro_torch.models import TPCtx, build
    from repro_torch.serve import ServeConfig, ServingEngine
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg, TPCtx(tp=T16, mode="coded", code_r=R))
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    scfg = ServeConfig(max_len=16 + N_TOK + 8, batch=4,
                       cache_dtype=torch.float32)
    batch = serve_batch(cfg.vocab)
    eng = ServingEngine(model, params, scfg, use_fused=True,
                        use_graphs=True)
    clean = _serve_run(eng, batch)
    _check_graph_run("T=16 fault-free", clean, 1)
    faulty = _serve_run(eng, batch, fail_at={4: 5})
    _check_graph_run("T=16 shard 5 dead", faulty, 1)
    eng.valid = np.ones(T16, bool)
    eng.use_graphs = False
    eager = _serve_run(eng, batch)
    _check_eager_run("T=16 eager", eager)
    del eng
    ref_eng = ServingEngine(model, params, scfg, use_fused=False)
    reference = _serve_run(ref_eng, batch)
    del ref_eng
    rounds = N_TOK - 1
    for name, res in (("fault-free", clean), ("shard 5 dead", faulty)):
        _check_launches(f"T=16 {name}", res, cfg, rounds, norms=True)
        if set(res["k1_variants"]) != {"rb4-async", "rb4-async-lead"} or \
                res["k2_variants"] != {"rb4-async": rounds}:
            raise AssertionError(f"T=16 {name}: instantiations "
                                 f"{res['k1_variants']} / "
                                 f"{res['k2_variants']}")
    if reference["k1"] or reference["k2"]:
        raise AssertionError("the T=16 reference variant launched a kernel")
    for name, res in (("shard 5 dead", faulty), ("reference", reference),
                      ("eager fused", eager)):
        if not np.array_equal(res["tokens"], clean["tokens"]):
            raise AssertionError(f"T=16 {name} tokens differ from the fused "
                                 f"fault-free run:\n{res['tokens']}\nvs\n"
                                 f"{clean['tokens']}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = {n: float(np.median(r["round_ms"])) for n, r in
           (("fused", clean), ("erasure", faulty), ("reference", reference))}
    log(f"served granite-3-8b at T = 16 (r = 2 folded, float32; params in "
        f"{init_s:.1f} s): identical streams on graph rounds fault-free "
        f"and with shard 5 erased at step 4 ({clean['vstep']['n_captures']} "
        f"+ {faulty['vstep']['n_captures']} graphs captured, "
        f"{clean['vstep']['n_replays']} + {faulty['vstep']['n_replays']} "
        f"replays), on eager fused rounds, and on the reference variant; "
        f"per fused round "
        f"{clean['k1'] // rounds} coded-GEMM launches "
        f"({clean['k1_variants']}) + {clean['k2'] // rounds} head "
        f"({clean['k2_variants']}); round medians {med} ms; "
        f"max_memory_allocated {peak:.2f} GiB")
    log("T=16 first stream:", clean["tokens"][0].tolist())
    return {"k1": clean["k1"], "k2": clean["k2"],
            "k1_variants": clean["k1_variants"], "round_ms": med,
            "eager_round_ms": float(np.median(eager["round_ms"])),
            "peak_gib": peak}


@contextlib.contextmanager
def recorded_rounds():
    """Keep what every decode round of VStep computes: the fused round's
    (token, max logit) from its own kernel-2 call (``VStep.last_head``,
    which a graph replay rewrites: copied on the device after each round),
    and the reference round's last-position logits."""
    from repro_torch.runtime.executor import vstep
    rec: dict[str, list] = {"fused": [], "reference": []}
    original = vstep.VStep.round

    def recorded(self, *a):
        out = original(self, *a)
        if self.last_variant == "fused":
            rec["fused"].append(tuple(t.clone() for t in self.last_head))
        else:
            rec["reference"].append(out[2][:, 0])
        return out

    vstep.VStep.round = recorded
    try:
        yield rec
    finally:
        vstep.VStep.round = original


def split_report(ft, rt, fused: list, reference: list, tol: float) -> list:
    """Where a fused stream first leaves the reference stream (token j >=
    1, made by decode round j - 1 from the same history): the reference
    round's top-2 logit gap, how far below the reference's max it puts the
    fused token, and kernel 2's max there. A fused token within ``tol`` of
    the reference's max is a bf16 rounding tie; one further below is a
    fault, and raises."""
    out = []
    for i, (a, b) in enumerate(zip(ft, rt)):
        j = int(np.argmin(np.append(a == b, False)))
        if j == len(a):
            continue
        if j == 0:
            raise AssertionError(f"bf16 stream {i}: the prefill tokens "
                                 f"differ ({a[0]} vs {b[0]})")
        logits = reference[j - 1][i].float()
        top = logits.topk(2).values
        below = float(top[0] - logits[int(a[j])])
        out.append({"stream": i, "token": j, "fused": int(a[j]),
                    "reference": int(b[j]),
                    "reference_top2_gap": float(top[0] - top[1]),
                    "fused_below_reference_max": below,
                    "fused_max": float(fused[j - 1][1][i]),
                    "reference_max": float(top[0])})
        if below > tol:
            raise AssertionError(f"bf16 stream {i} leaves the reference at "
                                 f"token {j} for a token {below:.4f} below "
                                 f"the reference's max (TOL {tol}): "
                                 f"{out[-1]}")
    return out


def serve_bf16(cfg) -> dict:
    """A bf16 coded granite-3-8b at full width (Model.init(dtype=bf16), T
    = 4, r = 2 folded): its parity encoded by kernel 4 on bf16 (6 leaves at
    init, 6 again at the engine's encode); 16 tokens served through the
    fused round (kernels 1, 2 and 6 on bf16: their bf16 instantiations,
    200 + 1 + 81 launches a round) and on the reference variant. The max
    logit of the first served round, from the fused round's own kernel-2
    call, must be within the reference's bf16 TOL (6e-2) of the reference
    round's; where a fused stream leaves the reference one (bf16 rounds
    in other places on the two paths: the streams are not required
    equal), its token must be within that TOL of the reference's max
    (``split_report``). Reported: the leading tokens on which the streams
    agree, device time per fused round by the profiler, a bf16 re-encode
    bitwise equal to the first, and kernel 4 timed per leaf and whole on
    the bf16 weights."""
    from repro_torch.kernels import cdc_encode
    from repro_torch.models import TPCtx, build
    from repro_torch.serve import ServeConfig, ServingEngine
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R))
    cdc_encode.cdc_encode.launches = 0
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=torch.bfloat16, device="cuda")
    scfg = ServeConfig(max_len=16 + N_TOK + 8, batch=4,
                       cache_dtype=torch.bfloat16)
    batch = serve_batch(cfg.vocab)
    eng = ServingEngine(model, params, scfg, use_fused=True,
                        use_graphs=True)
    torch.cuda.synchronize()
    encodes = cdc_encode.cdc_encode.launches
    leaves = _parity_leaves(eng.params)
    if encodes != 2 * len(leaves) or any(p.dtype != torch.bfloat16
                                         for p in leaves):
        raise AssertionError(f"bf16 model: {encodes} encode launches for "
                             f"{len(leaves)} leaves (twice), parity dtypes "
                             f"{sorted({str(p.dtype) for p in leaves})}")
    with recorded_rounds() as rec_f:
        fused = _serve_run(eng, batch)
    rounds = N_TOK - 1
    _check_graph_run("bf16 fused", fused, 1)
    _check_launches("bf16 fused", fused, cfg, rounds, norms=True)
    if set(fused["k1_variants"]) != {"rb4-async-bf16"} or \
            fused["k2_variants"] != {"rb4-async-lead-bf16": rounds} or \
            len(rec_f["fused"]) != rounds or rec_f["reference"]:
        raise AssertionError(f"bf16 fused: instantiations "
                             f"{fused['k1_variants']} / "
                             f"{fused['k2_variants']}, "
                             f"{len(rec_f['fused'])} fused and "
                             f"{len(rec_f['reference'])} reference rounds")
    med = float(np.median(fused["round_ms"]))
    breakdown = profile_rounds(eng.executor(4), eng.valid, med)
    eng.use_graphs = False
    eager = _serve_run(eng, batch)
    _check_eager_run("bf16 eager", eager)
    if not np.array_equal(eager["tokens"], fused["tokens"]):
        raise AssertionError(f"bf16 graph and eager fused rounds differ:\n"
                             f"{fused['tokens']}\nvs\n{eager['tokens']}")
    encode = reencode_and_time(eng.stepper)
    del eng
    ref_eng = ServingEngine(model, params, scfg, use_fused=False)
    with recorded_rounds() as rec_r:
        reference = _serve_run(ref_eng, batch)
    del ref_eng
    if len(rec_r["reference"]) != rounds or rec_r["fused"]:
        raise AssertionError(f"bf16 reference: {len(rec_r['reference'])} "
                             f"reference and {len(rec_r['fused'])} fused "
                             f"rounds")
    fmax = rec_f["fused"][0][1]
    rmax = rec_r["reference"][0].float().max(-1).values
    torch.testing.assert_close(fmax, rmax, rtol=6e-2, atol=6e-2, msg=(
        lambda m: f"bf16 first served round's max logit, fused vs "
                  f"reference: {m}"))
    ft, rt = fused["tokens"], reference["tokens"]
    agree = [int(np.argmin(np.append(a == b, False))) for a, b in zip(ft, rt)]
    splits = split_report(ft, rt, rec_f["fused"], rec_r["reference"], 6e-2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"bf16 granite-3-8b (T=4, r=2 folded): parity by kernel 4 on bf16 "
        f"({encodes} launches); first served round's max logit, fused "
        f"(kernel 2) {fmax.tolist()} vs reference {rmax.tolist()} (max abs "
        f"diff {float((fmax - rmax).abs().max()):.4f}, TOL 6e-2); fused "
        f"round median {med:.3f} ms on graph rounds (eager: "
        f"{float(np.median(eager['round_ms'])):.3f} ms, identical tokens), "
        f"reference "
        f"{float(np.median(reference['round_ms'])):.3f} ms; leading tokens "
        f"agreeing per stream {agree} of {N_TOK}; where they split {splits}; "
        f"launches a round "
        f"{fused['k1'] // rounds} / {fused['k2'] // rounds} / "
        f"{norms_per_pass(cfg)} ({fused['k1_variants']}, "
        f"{fused['k2_variants']}, {fused['k6_variants']}); "
        f"max_memory_allocated {peak:.2f} GiB")
    return {"first_step_max": {"fused": fmax.tolist(),
                               "reference": rmax.tolist()},
            "agree": agree, "splits": splits, "round_ms": med,
            "eager_round_ms": float(np.median(eager["round_ms"])),
            "breakdown": breakdown, "encode": encode, "encodes": encodes,
            "peak_gib": peak}


# ------------------------------------------------------------ phase 5 ----

CHAOS = "exp:mtbf=800,mttr=120"
CHAOS_SEED = 2     # its schedule has in-step recoveries, beyond-budget
#                    requeues and re-encodes, and drives the planner to r=4
SCHED_ARGS = ["--coded", "--tp", str(T), "--batch", "4", "--requests", "8",
              "--arrival-gap-ms", "2", "--prompt-len", "16",
              "--gen-tokens", "16", "--seed", str(CHAOS_SEED)]
RUNS = {"fault-free": [], "chaos": ["--chaos", CHAOS],
        "chaos+adapt-r": ["--chaos", CHAOS, "--adapt-r"]}
# the observability flags of each run on the card (the CPU runs that
# give the expected counters take none): the perf line, the validated
# trace and the SLO report
SMOKE_OUT = ROOT / "build" / "smoke"
# (the profiler's trace of the adapt-r run, with its re-encodes, captures
# and reference rounds, was 835 MB and 79 s of the phase on a slow host:
# the fault-free run's is a fraction of it)
OBS = {"fault-free": ["--perf", "--profile", str(SMOKE_OUT / "profile")],
       "chaos": ["--trace", str(SMOKE_OUT / "chaos.trace.json"),
                 "--slo-report"],
       "chaos+adapt-r": ["--perf"]}


def _kernel_wrappers():
    from repro_torch.kernels import (cdc_decode, cdc_encode, cdc_matmul,
                                     matmul, rmsnorm)
    return {"cdc_coded_matmul": cdc_matmul.cdc_coded_matmul,
            "cdc_fused_head_argmax": cdc_decode.cdc_fused_head_argmax,
            "cdc_encode": cdc_encode.cdc_encode,
            "cdc_decode_merge": cdc_matmul.cdc_decode_merge,
            "cdc_decode": cdc_decode.cdc_decode,
            "rmsnorm": rmsnorm.rmsnorm, "matmul": matmul.matmul}


def _scheduler_run(model, params, argv: list[str], device: str,
                   report: bool = False):
    """One run of the port's serving entry point (``launch.serve``): the
    stepper (whose build encodes the parity), the scheduler with the
    chaos injector, planner and observability the flags ask for, and the
    request stream; with ``report``, the entry point's summary lines
    (returning the perf summary and trace statistics)."""
    from repro_torch.launch import serve
    from repro_torch.serve import ModelStepper
    args = serve.parser().parse_args(argv + ["--device", device])
    stepper = ModelStepper(model, params,
                           max_len=args.prompt_len + args.gen_tokens + 8)
    sched = serve.build_scheduler(args, stepper, model.ctx.code_layout)
    done = serve.serve_requests(args, sched)
    out = serve.report(args, sched, done) if report else {}
    return stepper, sched, done, out


def scheduler_counters_cpu() -> dict:
    """The three runs' counters and planner r series at smoke size on the
    CPU: the schedule depends on the seed and the arrivals, not on the
    model's width, so the full-width runs must give the same ones."""
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import TPCtx, build
    cfg = smoke_config(get_arch("granite-3-8b"))
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R))
    params = model.init(0, device="cpu")
    out = {}
    for name, extra in RUNS.items():
        _, sched, done, _ = _scheduler_run(model, params,
                                           SCHED_ARGS + extra, "cpu")
        out[name] = {"counters": dict(sched.metrics.counters),
                     "r_series": [p["r"] for p in sched.metrics.plan_log],
                     "completed": len(done)}
    return out


def _parity_leaves(params) -> list[torch.Tensor]:
    """Every parity leaf of a param tree (dicts, and xLSTM's block list)."""
    if isinstance(params, list):
        return [t for v in params for t in _parity_leaves(v)]
    out = []
    for v in params.values():
        if isinstance(v, (dict, list)):
            out += _parity_leaves(v)
    if "cdc" in params:
        out.append(params["cdc"])
    return out


def serve_scheduler(cfg, device: str = "cuda") -> dict:
    """granite-3-8b at full width through the continuous-batching
    scheduler: fault-free, under seeded chaos, and under chaos with the
    adaptive planner, the same 8 requests each time."""
    from repro_torch.models import TPCtx, build
    t0 = time.perf_counter()
    expect = scheduler_counters_cpu()
    log(f"scheduler, smoke size on the CPU ({time.perf_counter() - t0:.1f} "
        f"s): " + "; ".join(
            f"{n}: {e['counters']['decode_rounds']} rounds, "
            f"{e['counters']['erasures_recovered']} recovered in-step, "
            f"{e['counters']['beyond_budget_failures']} beyond budget, "
            f"{e['counters']['parity_reencodes']} re-encodes, r series "
            f"{e['r_series']}" for n, e in expect.items()))
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R))
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    wrappers = _kernel_wrappers()
    SMOKE_OUT.mkdir(parents=True, exist_ok=True)
    runs, timing = {}, None
    for name, extra in RUNS.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        stepper, sched, done, obs = _scheduler_run(
            model, params, SCHED_ARGS + extra + OBS[name],
            device, report=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = {k: fn.launches for k, fn in wrappers.items()}
        c = dict(sched.metrics.counters)
        rs = [p["r"] for p in sched.metrics.plan_log]
        n_leaves = len(_parity_leaves(stepper.params))
        res = {"tokens": {q.rid: list(q.tokens) for q in done},
               "counters": c, "r_series": rs, "seconds": secs,
               "launches": launches,
               "round_ms": float(np.median(sched.executor.round_ms)),
               "reencode_wall_ms": stepper.last_reencode_wall_ms,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "graphs": _check_scheduler_graphs(name, sched, stepper, T)}
        res.update(_check_observability(name, sched, stepper, obs,
                                        OBS[name]))
        runs[name] = res
        want = expect[name]
        if len(done) != 8 or any(len(q.tokens) != 16 for q in done):
            raise AssertionError(f"{name}: {len(done)}/8 requests completed")
        if c != want["counters"] or rs != want["r_series"]:
            raise AssertionError(
                f"{name}: counters {c} / r series {rs} differ from the "
                f"CPU run's {want['counters']} / {want['r_series']}")
        if launches["cdc_encode"] != n_leaves * (1 + c["parity_reencodes"]):
            raise AssertionError(
                f"{name}: {launches['cdc_encode']} encode launches for "
                f"{1 + c['parity_reencodes']} encodes of {n_leaves} leaves")
        if not (launches["cdc_coded_matmul"] and
                launches["cdc_fused_head_argmax"]):
            raise AssertionError(f"{name}: no fused round ran: {launches}")
        # every dispatched round (fused or reference) and every prefill
        # (one per admission, requeued requests' second ones included)
        # runs its norms through kernel 6
        passes = sched.executor.vstep.n_dispatches + c["requests_admitted"]
        res["passes"] = {"rounds": sched.executor.vstep.n_dispatches,
                         "prefills": c["requests_admitted"]}
        if launches["rmsnorm"] != norms_per_pass(cfg) * passes:
            raise AssertionError(
                f"{name}: {launches['rmsnorm']} rmsnorm launches for "
                f"{res['passes']}; expected {norms_per_pass(cfg)} each")
        if name != "fault-free" and res["tokens"] != runs["fault-free"][
                "tokens"]:
            raise AssertionError(f"{name}: token streams differ from the "
                                 f"fault-free run")
        log(f"scheduler {name}: {c['requests_completed']}/8 completed, "
            f"{c['decode_rounds']} rounds in {secs:.2f} s, round_ms median "
            f"{res['round_ms']:.3f}, {c['erasures_recovered']} recovered "
            f"in-step, {c['beyond_budget_failures']} beyond budget, "
            f"{c['requests_requeued']} requeued, {c['parity_reencodes']} "
            f"re-encodes (last {res['reencode_wall_ms']:.3f} ms wall), r "
            f"series {rs}, launches {launches}, max_memory_allocated "
            f"{res['peak_gib']:.2f} GiB")
        if name == "fault-free":
            # before the chaos runs, so that only one parity set is alive
            timing = reencode_and_time(stepper)
        del stepper, sched, done
    chaos, adapt = runs["chaos"]["counters"], runs["chaos+adapt-r"]
    if not (chaos["erasures_recovered"] and chaos["beyond_budget_failures"]
            and chaos["parity_reencodes"]):
        raise AssertionError(f"chaos run lacks a recovery, a requeue or a "
                             f"re-encode: {chaos}")
    if 4 not in adapt["r_series"]:
        raise AssertionError(f"the planner never reached r=4: "
                             f"{adapt['r_series']}")
    log("scheduler: every request completed in all three runs, token "
        "streams identical to the fault-free run, counters equal to the "
        "CPU run's")
    return {"runs": runs, "timing": timing}


def _check_scheduler_graphs(name: str, sched, stepper, t: int) -> dict:
    """A scheduler run on graph rounds: one replay per fused round, at
    most T + 1 graphs per encode generation, none left from an older
    generation; graphs dropped at most once per encode after the first
    (a re-encode or an r change)."""
    vs = sched.executor.vstep
    gen = stepper.encode_generation
    c = {k: getattr(vs, k) for k in VSTEP_COUNTERS}
    stale = [k for k in vs._graphs if k[0] != gen]
    if not vs.use_graphs or c["n_replays"] != c["n_fused_rounds"] \
            or c["n_captures"] > (t + 1) * (gen + 1) \
            or c["n_graph_drops"] > gen or stale:
        raise AssertionError(f"{name}: graph counters {c}, {gen} encodes "
                             f"after the first, stale graphs {stale}")
    rs = [R] + [p["r"] for p in sched.metrics.plan_log if p["applied"]]
    resizes = sum(a != b for a, b in zip(rs, rs[1:]))
    log(f"scheduler {name}: {c['n_replays']} replays for "
        f"{c['n_fused_rounds']} fused of {c['n_dispatches']} rounds, "
        f"{c['n_captures']} graphs captured, dropped {c['n_graph_drops']} "
        f"times beside {sched.metrics.counters['parity_reencodes']} "
        f"re-encodes ({resizes} of them r changes; {gen} encodes after "
        f"the first)")
    return {**c, "encodes_after_first": gen, "r_changes": resizes}


# the fused round's counted bytes over the weights' bytes, at full width:
# activations, the KV cache and the embedding rows add under 5%
PERF_BOUND_TOL = 0.05


def _round_weight_bytes(stepper) -> float:
    """Bytes a fused round must read at the least: every layer weight and
    parity leaf, the LM head and its sum parity (a shard's width)."""
    def leaves(node):
        if isinstance(node, dict):
            return [t for v in node.values() for t in leaves(v)]
        return [node]
    head = stepper.params["lm_head"]["w"]
    return float(sum(t.numel() * t.element_size()
                     for t in leaves(stepper.params["layers"]))
                 + head.numel() * head.element_size()
                 * (1 + 1 / stepper.n_shards))


def _check_observability(name: str, sched, stepper, obs: dict,
                         flags: list[str],
                         least_bytes: float | None = None) -> dict:
    """What each observability flag of the run (``flags``) must give: the
    perf line's attribution (every launch costed; its bytes bound within
    5% of the round's least bytes over the card's HBM rate: the weights',
    unless ``least_bytes`` gives them), the chaos trace (validated with
    every injected erasure linked, 0 dropped events) with the SLO report,
    the profiler trace file."""
    from repro_torch.obs.export import validate_chrome_trace
    out = {}
    if "--perf" in flags or "--profile" in flags or "--trace" in flags:
        perf = obs.get("perf")
        if not perf or any(c.get("custom_calls_uncosted") != 0
                           for c in perf["variants"].values()) \
                or "fused" not in perf["variants"]:
            raise AssertionError(f"{name}: perf summary {perf}")
        # the fused round at the run's last code geometry
        fused = perf["variants"]["fused"]
        if least_bytes is None:
            least_bytes = _round_weight_bytes(stepper)
        want = least_bytes / HBM_BYTES_PER_S * 1e6
        got = fused["bound_step_s"] * 1e6
        if fused["dominant"] != "memory" or \
                abs(got / want - 1) > PERF_BOUND_TOL:
            raise AssertionError(f"{name}: fused-round bound {got:.1f} us, "
                                 f"least bytes alone {want:.1f} us")
        out["perf"] = {k: v for k, v in perf.items() if k != "variants"}
        out["perf"]["weight_bound_us"] = want
        out["perf"]["attributions"] = sched.executor.perf.n_attributions
        out["perf"]["fused"] = fused
        log(f"scheduler {name}: fused-round bound {got / 1e3:.4f} ms "
            f"(least bytes alone {want / 1e3:.4f} ms), "
            f"{fused['flops'] / 1e9:.3f}"
            f" GFLOP ({fused['useful_flops'] / 1e9:.3f} useful, "
            f"{fused['bytes'] / 1e9:.3f} GB), "
            f"{sched.executor.perf.n_attributions} attribution(s)")
    if "--trace" in flags:
        path = flags[flags.index("--trace") + 1]
        with open(path) as f:
            stats = validate_chrome_trace(json.load(f),
                                          require_fault_links=True,
                                          require_span_closure=True)
        if stats["dropped_events"] != 0 or \
                stats["n_linked"] != stats["n_injected_erasures"]:
            raise AssertionError(f"{name}: trace {stats}")
        out["trace"] = stats
        log(f"scheduler {name}: trace validated with every fault linked "
            f"({stats['n_linked']} of {stats['n_injected_erasures']} "
            f"injected erasures, {stats['dropped_events']} dropped events, "
            f"{stats['n_span_trees']} span trees)")
    if "--profile" in flags:
        path = Path(flags[flags.index("--profile") + 1]) / "trace.json"
        size = path.stat().st_size if path.exists() else 0
        if size == 0:
            raise AssertionError(f"{name}: no profiler trace at {path}")
        out["profile_bytes"] = size
        log(f"scheduler {name}: torch.profiler trace {path} ({size} bytes)")
    return out


def reencode_and_time(stepper, t: int = T, r: int = R) -> dict:
    """A re-encode of unchanged weights must give bitwise-equal parity;
    then kernel 4 per leaf and for the whole re-encode, its bound, its
    plain version (the tensordot-and-fold path) and torch.matmul on a
    contiguous copy of the shards (the yardstick), in the weights'
    storage type."""
    from repro_torch.core.coding import generator_matrix
    from repro_torch.kernels import cdc_encode as enc
    before = [p.clone() for p in _parity_leaves(stepper.params)]
    walls = []
    for _ in range(3):
        stepper.reencode()
        walls.append(stepper.last_reencode_wall_ms)
    after = _parity_leaves(stepper.params)
    if len(after) != len(before) or not all(
            torch.equal(a, b) for a, b in zip(after, before)):
        raise AssertionError("re-encoding unchanged weights changed the "
                             "parity bits")
    del before, after
    torch.cuda.empty_cache()
    log(f"re-encode of unchanged weights: every parity leaf bitwise equal; "
        f"last_reencode_wall_ms {', '.join(f'{x:.3f}' for x in walls)}")
    scratch = torch.empty(64 * 2 ** 20, device="cuda")   # 256 MB > L2
    flush = scratch.zero_
    g = generator_matrix(t, r)
    raw = stepper._raw_params
    dtype = raw["lm_head"]["w"].dtype
    e = torch.finfo(dtype).bits / 8
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    gt = torch.as_tensor(g.astype(np.float32), device="cuda").to(dtype)
    leaves = [("wq", raw["layers"]["attn"]["wq"]["w"]),
              ("wk", raw["layers"]["attn"]["wk"]["w"]),
              ("wv", raw["layers"]["attn"]["wv"]["w"]),
              ("w1", raw["layers"]["ffn"]["w1"]["w"]),
              ("w3", raw["layers"]["ffn"]["w3"]["w"]),
              ("lm_head", raw["lm_head"]["w"])]
    rows = []
    for name, w in leaves:
        sh = _shards(w, t)
        ms = _time(lambda: enc.cdc_encode(sh, g, layout="folded"), flush, 10)
        plain = _time(lambda: enc.encode_plain(sh, g, "folded"), flush, 5)
        flat = sh.contiguous().reshape(sh.shape[:-2] + (-1,))
        lib = _time(lambda: torch.matmul(gt, flat), flush, 10)
        del flat
        n = sh.numel()                     # t * (L *) k * m_l
        bound, by = _bound(e * n * (t + r) / t, 2.0 * n * r, peak)
        rows.append({"leaf": name, "shape": list(w.shape), "ms": ms,
                     "plain_ms": plain, "library_ms": lib,
                     "bound_ms": bound, "bound_by": by})
        log(f"cdc_encode {name} {list(w.shape)} {dtype} T={t} r={r} folded: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library matmul "
            f"{lib:.4f} ms, bound {bound:.4f} ms ({by})")
    whole = _time(lambda: stepper.model.encode_offline(raw), flush, 10)
    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"whole re-encode ({len(rows)} launches, {dtype}): {whole:.4f} ms "
        f"by events around encode_offline; per-leaf sums: kernel "
        f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, library "
        f"{total['library_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms")
    return {"leaves": rows, "whole_ms": whole, "total": total,
            "reencode_wall_ms": walls}


def time_t12(cfg, rows: int = 4) -> list[dict]:
    """The generic instantiations at granite's T = 12 shapes (what
    ``launch.serve --coded --tp 12`` runs; r = 2 folded, 4 rows, no shard
    dead): kernel 1 at wq, wk and w1 (w1's 89-column slices on the
    row copies), kernel 2 at the head, kernel 3 at w1 with shard 2
    dead and kernel 5 at [12, 4, 1068]; beside their plain versions, one
    library call (torch.matmul of x over the same weights, concatenated;
    none for 3 and 5) and their bounds. Kernel 4's T = 12 row, a whole
    re-encode, is timed in ``serve_t12``."""
    from repro_torch.core.coded_layer import CodedDenseSpec, unfold_parity
    from repro_torch.core.coding import CodeSpec
    from repro_torch.kernels import cdc_decode, cdc_matmul, ref
    gen = torch.Generator(device="cuda").manual_seed(44)
    scratch = torch.empty(64 * 2 ** 20, device="cuda")   # 256 MB > L2
    flush = scratch.zero_
    t, r, out = T12, R, []
    valid = (True,) * t
    for name, m_l in granite_widths(t).items():
        spec, x, w, wc = _coded_case(m_l, rows, "folded", gen, r=r, t=t)
        wcat = torch.cat([w, unfold_parity(wc, t, r).permute(1, 0, 2)
                          .reshape(K, r * m_l)], dim=1)
        cdc_matmul.cdc_coded_matmul.variants.clear()
        ms = _time(lambda: _run_coded(x, w, wc, spec, valid), flush)
        variant, = cdc_matmul.cdc_coded_matmul.variants
        plain = _time(lambda: _run_coded(x, w, wc, spec, valid, plain=True),
                      flush)
        lib = _time(lambda: torch.matmul(x, wcat), flush)
        bound, by = _bound(4.0 * (rows * K + (t + r) * K * m_l
                                  + rows * t * m_l + 2 * m_l),
                           2.0 * rows * K * m_l * (t + r))
        rb = int(variant.split("-")[0][2:])
        usage = _usage(f"coded_stream_kernelILi0ELi0ELi1ELi{rb}ELb"
                       f"{int('-async' in variant)}E", rb)
        out.append({"gemm": name, "r": r, "rows": rows, "m_l": m_l,
                    "case": "T=12 float32", "ms": ms, "plain_ms": plain,
                    "library_ms": lib, "bound_ms": bound, "bound_by": by,
                    "variant": variant, "ptxas": usage})
        log(f"cdc_coded_matmul {name} T=12 [rows={rows}, k={K}, m_l={m_l}, "
            f"r={r} folded]: kernel {ms:.4f} ms ({ms / bound:.2f}x the "
            f"bound), plain {plain:.4f} ms, library matmul {lib:.4f} ms, "
            f"bound {bound:.4f} ms ({by}); {variant}: {usage}")
        del x, w, wc, wcat
    m_l = _pad_head(cfg.vocab, t)
    w = torch.randn((K, t * m_l), generator=gen, device="cuda") / K ** 0.5
    w_shards, pw = _head_views(w, t)
    wcat = torch.cat([w, pw], dim=1)
    x = torch.randn((rows, K), generator=gen, device="cuda")
    cdc_decode.cdc_fused_head_argmax.variants.clear()
    ms = _time(lambda: cdc_decode.cdc_fused_head_argmax(
        x, w_shards, pw, valid, vocab=cfg.vocab), flush)
    variant, = cdc_decode.cdc_fused_head_argmax.variants
    vt = torch.tensor(valid)
    plain = _time(lambda: ref.fused_head_argmax_ref(x, w_shards, pw, vt,
                                                    cfg.vocab), flush)
    lib = _time(lambda: torch.matmul(x, wcat), flush)
    bound, by = _bound(4.0 * (rows * K + (t + 1) * K * m_l + 2 * rows),
                       2.0 * rows * K * m_l * (t + 1))
    rb = int(variant.split("-")[0][2:])
    usage = _usage(f"head_stream_kernelILi0ELi{rb}ELb"
                   f"{int('-async' in variant)}EfE", rb)
    out.append({"gemm": "lm_head", "rows": rows, "m_l": m_l,
                "case": "T=12 float32", "ms": ms, "plain_ms": plain,
                "library_ms": lib, "bound_ms": bound, "bound_by": by,
                "variant": variant, "ptxas": usage})
    log(f"cdc_fused_head_argmax T=12 [b={rows}, k={K}, m_l={m_l}]: kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, library matmul {lib:.4f} ms, "
        f"bound {bound:.4f} ms ({by}); {variant}: {usage}")
    del w, w_shards, pw, wcat
    m_l = granite_widths(t)["w1"]
    spec = CodedDenseSpec(CodeSpec(t, r))
    dead2 = tuple(i != 2 for i in range(t))
    vh, esel, coef, g = _dm_plan(spec, dead2, m_l)
    ys = torch.randn((t, rows, m_l), generator=gen, device="cuda")
    par = torch.randn((t, rows, r * m_l // t), generator=gen, device="cuda")
    call = (ys, par, "folded", t, r, g, esel, coef, vh)
    cdc_matmul.cdc_decode_merge.variants.clear()
    ms = _time(lambda: cdc_matmul.cdc_decode_merge(*call), flush)
    plain = _time(lambda: cdc_matmul.decode_merge_plain(*call), flush)
    _row(out, "cdc_decode_merge", f"[{t}, {rows}, {m_l}] r={r} folded",
         ms, plain, None, 4.0 * (2 * t * rows * m_l) + 8.0 * m_l,
         rows * m_l * (2.0 * t + 2))
    # the generic instantiation (T a runtime value) of the one launched
    out[-1]["variant"] = "generic-" + "".join(
        cdc_matmul.cdc_decode_merge.variants)
    y = torch.randn((t, rows, m_l), generator=gen, device="cuda")
    p = y.sum(0)
    vt = torch.tensor(dead2, device="cuda")
    n = p.numel()
    cdc_decode.cdc_decode.variants.clear()
    ms = _time(lambda: cdc_decode.cdc_decode(y, p, dead2), flush)
    plain = _time(lambda: ref.cdc_decode_ref(y, p, vt), flush)
    _row(out, "cdc_decode", str([t, rows, m_l]), ms, plain, None,
         4.0 * (2 * t + 1) * n, n * (3.0 * t + 1))
    out[-1]["variant"] = "generic-" + "".join(cdc_decode.cdc_decode.variants)
    log(f"  instantiations: cdc_decode_merge {out[-2]['variant']}, "
        f"cdc_decode {out[-1]['variant']}")
    return out


# ----------------------------------------------------- phases 10 - 12 ----

T12 = 12


def _perf_of_fused_round(eng, weights_only: bool = True) -> dict:
    """What ``--perf`` attributes to the engine's fused round (counted on
    clones of its slot state): every launch costed, and (``weights_only``:
    a short KV cache) the bytes bound within 5% of the round's weight
    bytes over the HBM rate."""
    from repro_torch.obs.perf import attribute_round_costs
    ex = eng.executor(4)
    fused = attribute_round_costs(ex.vstep, ex.state, ex.last_toks)["fused"]
    want = _round_weight_bytes(eng.stepper) / HBM_BYTES_PER_S * 1e3
    got = fused.bound_step_s * 1e3
    if fused.custom_calls_uncosted or fused.dominant != "memory" or \
            (weights_only and abs(got / want - 1) > PERF_BOUND_TOL):
        raise AssertionError(f"perf of the fused round: {fused} (weights "
                             f"alone {want:.4f} ms)")
    log(f"perf of the fused round (T = {fused.T}, r = {fused.r}): "
        f"{fused.useful_flops / 1e9:.3f} GFLOP useful, "
        f"{fused.flops / 1e9:.3f} in all (parity_device_equiv "
        f"{fused.parity_device_equiv:.3f}), {fused.bytes / 1e9:.3f} GB, "
        f"bound {got:.4f} ms (weights alone {want:.4f} ms), 0 uncosted")
    return {"flops": fused.flops, "useful_flops": fused.useful_flops,
            "bytes": fused.bytes, "bound_ms": got, "weight_bound_ms": want,
            "parity_device_equiv": fused.parity_device_equiv}


def _serve_every_way(tag: str, cfg, model, params, scfg, batch, t: int,
                     dead: int, on_engine) -> dict:
    """The requests through ServingEngine.generate every way the port
    serves them, fault-free and with shard ``dead`` killed at step 4: on
    graph rounds, on eager fused rounds, on the reference variant, and
    kernel-free (the reference variant with plain norms). Every stream
    must equal the fault-free graph run's; each fused round launches
    kernel 1 for every coded GEMM and kernel 2 once, kernel 6 for every
    round and prefill; the reference runs launch no coded kernel, the
    kernel-free one none at all. ``on_engine(eng)`` runs on the fused
    engine between its graph and eager runs (all shards healthy). Returns
    the runs, the profiler's device time of a graph round and what
    ``on_engine`` returned."""
    from repro_torch.kernels import ref
    from repro_torch.models import transformer
    from repro_torch.serve import ServingEngine
    rounds, down = N_TOK - 1, f"shard {dead} dead"
    eng = ServingEngine(model, params, scfg, use_fused=True,
                        use_graphs=True)
    runs = {"graph": _serve_run(eng, batch)}
    runs[f"graph, {down}"] = _serve_run(eng, batch, fail_at={4: dead})
    for name in ("graph", f"graph, {down}"):
        _check_graph_run(f"{tag} {name}", runs[name], 1)
    eng.valid = np.ones(t, bool)
    prof = profile_rounds(eng.executor(4), eng.valid,
                          float(np.median(runs["graph"]["round_ms"])))
    extra = on_engine(eng)
    eng.use_graphs = False
    runs["eager"] = _serve_run(eng, batch)
    runs[f"eager, {down}"] = _serve_run(eng, batch, fail_at={4: dead})
    for name in ("eager", f"eager, {down}"):
        _check_eager_run(f"{tag} {name}", runs[name])
    del eng
    ref_eng = ServingEngine(model, params, scfg, use_fused=False)
    runs["reference"] = _serve_run(ref_eng, batch)
    runs[f"reference, {down}"] = _serve_run(ref_eng, batch,
                                            fail_at={4: dead})
    norm = transformer.rmsnorm
    transformer.rmsnorm = lambda p, x, eps: ref.rmsnorm_ref(x, p["g"], eps)
    try:
        runs["kernel-free"] = _serve_run(ref_eng, batch)
    finally:
        transformer.rmsnorm = norm
    del ref_eng
    clean = runs["graph"]
    for name, res in runs.items():
        if name.startswith(("graph", "eager")):
            _check_launches(f"{tag} {name}", res, cfg, rounds, norms=True)
        elif res["k1"] or res["k2"]:
            raise AssertionError(f"{tag} {name} launched a coded kernel")
        if not np.array_equal(res["tokens"], clean["tokens"]):
            raise AssertionError(f"{tag} {name} tokens differ from the "
                                 f"fault-free graph run:\n{res['tokens']}\n"
                                 f"vs\n{clean['tokens']}")
    if runs["kernel-free"]["k6"]:
        raise AssertionError(f"the {tag} kernel-free run launched kernel 6")
    return {"runs": runs, "profile": prof, **extra}


def serve_t12(cfg) -> dict:
    """granite-3-8b at full width at T = 12, what ``launch.serve --coded
    --tp 12`` builds (float32, r = 2 folded, heads padded to 36/9 with
    zero weights), through ServingEngine.generate: 4 requests, prompt 16,
    16 new tokens, every way the port serves them, fault-free and with
    shard 7 killed at step 4 (``_serve_every_way``): every stream
    identical. Each fused round launches kernel 1 200 times and kernel 2
    once (their generic instantiations) and kernel 6 81 times; the
    engine's encode launches kernel 4 once a parity leaf; the profiler
    gives the device ms per round by kernel, the perf attribution the
    round's bound; kernel 4 is timed on a whole re-encode."""
    from repro_torch.kernels import cdc_encode
    from repro_torch.models import TPCtx, build
    from repro_torch.serve import ServeConfig
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg, TPCtx(tp=T12, mode="coded", code_r=R))
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    scfg = ServeConfig(max_len=16 + N_TOK + 8, batch=4,
                       cache_dtype=torch.float32)
    rounds = N_TOK - 1
    cdc_encode.cdc_encode.launches = 0

    def on_engine(eng):
        k4 = cdc_encode.cdc_encode.launches    # the engine's encode
        if k4 != len(_parity_leaves(eng.params)):
            raise AssertionError(f"T=12 engine: {k4} encode launches for "
                                 f"{len(_parity_leaves(eng.params))} "
                                 f"leaves")
        return {"k4": k4, "perf": _perf_of_fused_round(eng),
                "encode": reencode_and_time(eng.stepper, T12, R)}

    out = _serve_every_way("T=12", cfg, model, params, scfg,
                           serve_batch(cfg.vocab), T12, 7, on_engine)
    runs = out.pop("runs")
    clean = runs["graph"]
    for name, res in runs.items():
        if res["k1"] and (
                not all(v.endswith("-any") for v in res["k1_variants"])
                or set(res["k2_variants"]) != {"rb4-async-any"}):
            raise AssertionError(f"T=12 {name}: instantiations "
                                 f"{res['k1_variants']} / "
                                 f"{res['k2_variants']}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    meds = {n: float(np.median(r["round_ms"])) for n, r in runs.items()}
    if not meds["graph"] < meds["reference"]:
        raise AssertionError(f"T=12: the graph round's median "
                             f"{meds['graph']:.3f} ms is not below the "
                             f"reference variant's {meds['reference']:.3f}")
    # kernel 1's w1 and w3 are the round's only launches of its row-copy
    # instantiation (coded_stream_kernel<..., false, ...>)
    copied = {k: v for k, v in out["profile"].get("by_kernel", {}).items()
              if "coded_stream_kernel" in k and "false" in k}
    if copied:
        ms1 = sum(v["ms"] for v in copied.values())
        n1 = sum(v["count"] for v in copied.values())
        out["k1_rowcopy_us"] = ms1 * 1e3 / max(n1, 1)
        log(f"T=12 kernel 1 at w1/w3 (row copies) by the profiler: "
            f"{out['k1_rowcopy_us']:.3f} us a launch, {n1} a round, "
            f"{ms1:.3f} ms a round")
    enc = out["encode"]
    log(f"T=12 whole re-encode by kernel 4: {enc['whole_ms']:.4f} ms against "
        f"a {enc['total']['bound_ms']:.4f} ms bound "
        f"({enc['total']['bound_ms'] / enc['whole_ms']:.1%} of it), library "
        f"yardstick {enc['total']['library_ms']:.4f} ms")
    if not enc["whole_ms"] < enc["total"]["library_ms"]:
        raise AssertionError(f"T=12: a whole re-encode by kernel 4 "
                             f"({enc['whole_ms']:.4f} ms) is not below the "
                             f"library yardstick "
                             f"({enc['total']['library_ms']:.4f} ms)")
    log(f"served granite-3-8b at T = 12 (r = 2 folded, float32, heads "
        f"padded to 36/9; params in {init_s:.1f} s): identical streams on "
        f"graph and eager fused rounds and the reference variant, "
        f"fault-free and with shard 7 erased at step 4, and kernel-free; "
        f"per fused round {clean['k1'] // rounds} coded-GEMM launches "
        f"({clean['k1_variants']}) + {clean['k2'] // rounds} head "
        f"({clean['k2_variants']}) + {norms_per_pass(cfg)} rmsnorm; round "
        f"medians {meds} ms; max_memory_allocated {peak:.2f} GiB")
    log("T=12 first stream:", clean["tokens"][0].tolist())
    return {"k1": clean["k1"], "k2": clean["k2"], "k6": clean["k6"],
            "k1_variants": clean["k1_variants"], "round_ms": meds,
            "peak_gib": peak, "init_s": init_s, **out}


H2O = "h2o-danube-1.8b"
H2O_ARGS = ["--arch", H2O, "--coded", "--tp", str(T), "--batch", "4",
            "--requests", "8", "--arrival-gap-ms", "2", "--prompt-len", "16",
            "--gen-tokens", "16", "--seed", str(CHAOS_SEED)]
H2O_PROMPT = 4090     # + 16 new tokens: decode crosses the 4096 window


def serve_h2o(device: str = "cuda") -> dict:
    """h2o-danube-1.8b at full width (24 layers, d 2560, 32/8 heads of 80,
    d_ff 6912, vocab 32000, sliding window 4096; float32, T = 4, r = 2
    folded). (a) Through the serving entry point (``launch.serve --arch
    h2o-danube-1.8b --coded --perf``: the scheduler, 4 slots, 8 requests):
    every request completes and the counters equal the same run's at
    smoke size on the CPU; the perf line costs every launch and its
    fused-round bound is within 5% of the weights' bytes over the HBM
    rate. (b) Through ServingEngine.generate: 4 requests with a 4090-token
    prompt and 16 new tokens, so decode crosses the window and the ring
    cache (4096 slots) wraps; graph and eager fused rounds, the reference
    variant and the kernel-free run, fault-free and with shard 1 dead at
    step 4, all give the same streams; each fused round launches kernel 1
    120 times, kernel 2 once and kernel 6 49 times; the perf attribution
    of that round (every launch costed)."""
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import TPCtx, build
    from repro_torch.serve import ServeConfig
    cfg = get_arch(H2O)
    # (a) the serving entry point, against its CPU run at smoke size
    scfg_cpu = smoke_config(cfg)
    m_cpu = build(scfg_cpu, TPCtx(tp=T, mode="coded", code_r=R))
    _, s_cpu, d_cpu, _ = _scheduler_run(m_cpu, m_cpu.init(0, device="cpu"),
                                        H2O_ARGS, "cpu")
    want = dict(s_cpu.metrics.counters)
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R))
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    stepper, sched, done, obs = _scheduler_run(
        model, params, H2O_ARGS + ["--perf"], device,
        report=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = dict(sched.metrics.counters)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    if len(done) != 8 or any(len(q.tokens) != 16 for q in done) or \
            c != want or len(d_cpu) != 8:
        raise AssertionError(f"h2o scheduler: {len(done)}/8 completed, "
                             f"counters {c} vs the CPU run's {want}")
    passes = sched.executor.vstep.n_dispatches + c["requests_admitted"]
    if launches["rmsnorm"] != norms_per_pass(cfg) * passes or not \
            launches["cdc_coded_matmul"]:
        raise AssertionError(f"h2o scheduler launches {launches}")
    perf = _check_observability("fault-free", sched, stepper, obs,
                                ["--perf"])
    sched_out = {"counters": c, "seconds": secs, "launches": launches,
                 "round_ms": float(np.median(sched.executor.round_ms)),
                 "graphs": _check_scheduler_graphs("h2o fault-free", sched,
                                                   stepper, T), **perf}
    log(f"h2o-danube-1.8b scheduler: 8/8 completed, {c['decode_rounds']} "
        f"rounds in {secs:.2f} s, round_ms median "
        f"{sched_out['round_ms']:.3f}, counters equal to the CPU run's, "
        f"launches {launches}")
    del stepper, sched, done
    torch.cuda.empty_cache()
    # (b) one batch across the window
    scfg = ServeConfig(max_len=H2O_PROMPT + N_TOK + 8, batch=4,
                       cache_dtype=torch.float32)
    if model.empty_decode(1, scfg.max_len)["kv"]["k"].shape[2] != \
            cfg.window:
        raise AssertionError("h2o: the ring cache is not the window")
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab, (4, H2O_PROMPT))}
    # the 4096-slot KV cache is ~5% of the round's bytes beside the weights
    out = _serve_every_way(
        "h2o", cfg, model, params, scfg, batch, T, 1,
        lambda eng: {"perf": _perf_of_fused_round(eng, weights_only=False)})
    runs = out.pop("runs")
    clean, rounds = runs["graph"], N_TOK - 1
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    meds = {n: float(np.median(r["round_ms"])) for n, r in runs.items()}
    log(f"served h2o-danube-1.8b (window {cfg.window}) with a "
        f"{H2O_PROMPT}-token prompt and {N_TOK} new tokens: identical "
        f"streams on graph and eager fused rounds and the reference variant "
        f"(fault-free and with shard 1 erased at step 4), and kernel-free; "
        f"per fused round {clean['k1'] // rounds} coded-GEMM + "
        f"{clean['k2'] // rounds} head + {norms_per_pass(cfg)} rmsnorm "
        f"launches; round medians {meds} ms; max_memory_allocated "
        f"{peak:.2f} GiB")
    return {"scheduler": sched_out, "k1": clean["k1"], "k2": clean["k2"],
            "k6": clean["k6"], "round_ms": meds, "peak_gib": peak, **out}


DEEPSEEK_LAYERS = 12      # of 95: 95 float32 layers would need ~350 GB


def serve_deepseek() -> dict:
    """deepseek-67b at full width (d 8192, 64/8 heads, d_ff 22016, vocab
    102400; float32, T = 4, r = 2 folded), 12 of its 95 layers (~52 GB
    with the parity), through ServingEngine.generate: 4 requests, prompt
    16, 8 new tokens; fused graph rounds and the reference variant give
    the same streams. Each fused round launches kernel 1 60 times (at k =
    8192), kernel 2 once and kernel 6 25 times; the perf attribution of
    the round: every launch costed, its bytes bound within 5% of the
    weights' bytes over the HBM rate."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import TPCtx, build
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = dataclasses.replace(get_arch("deepseek-67b"),
                              n_layers=DEEPSEEK_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R))
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_tok = 8
    scfg = ServeConfig(max_len=16 + n_tok + 8, batch=4,
                       cache_dtype=torch.float32)
    batch = serve_batch(cfg.vocab)
    eng = ServingEngine(model, params, scfg, use_fused=True,
                        use_graphs=True)
    fused = _serve_run(eng, batch, n_tok=n_tok)
    _check_graph_run("deepseek fused", fused, 1)
    med = float(np.median(fused["round_ms"]))
    prof = profile_rounds(eng.executor(4), eng.valid, med)
    perf = _perf_of_fused_round(eng)
    del eng
    ref_eng = ServingEngine(model, params, scfg, use_fused=False)
    reference = _serve_run(ref_eng, batch, n_tok=n_tok)
    del ref_eng
    rounds = n_tok - 1
    _check_launches("deepseek fused", fused, cfg, rounds, norms=True)
    if reference["k1"] or reference["k2"]:
        raise AssertionError("the deepseek reference variant launched a "
                             "coded kernel")
    if not np.array_equal(fused["tokens"], reference["tokens"]):
        raise AssertionError(f"deepseek fused tokens differ from the "
                             f"reference variant's:\n{fused['tokens']}\nvs"
                             f"\n{reference['tokens']}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    meds = {"fused": med,
            "reference": float(np.median(reference["round_ms"]))}
    log(f"served deepseek-67b at full width, {DEEPSEEK_LAYERS} of 95 "
        f"layers (params in {init_s:.1f} s): fused graph rounds and the "
        f"reference variant give the same {n_tok}-token streams; per fused "
        f"round {fused['k1'] // rounds} coded-GEMM "
        f"({fused['k1_variants']}) + {fused['k2'] // rounds} head "
        f"({fused['k2_variants']}) + {norms_per_pass(cfg)} rmsnorm "
        f"launches; round medians {meds} ms; max_memory_allocated "
        f"{peak:.2f} GiB")
    return {"k1": fused["k1"], "k2": fused["k2"], "k6": fused["k6"],
            "k1_variants": fused["k1_variants"], "round_ms": meds,
            "profile": prof, "perf": perf, "peak_gib": peak,
            "init_s": init_s}


# ------------------------------------------------------------ phase 13 ----

WHISPER_ARGS = ["--arch", WHISPER, "--coded", "--tp", str(T), "--batch", "4",
                "--requests", "8", "--arrival-gap-ms", "2", "--prompt-len",
                "16", "--gen-tokens", "16", "--seed", str(CHAOS_SEED)]


def _whisper_round_bytes(stepper, state) -> float:
    """Bytes a whisper fused round must read at the least: every decoder
    weight and parity leaf it multiplies (the cross-attention's wk and wv
    only fill the bank at admission), the LM head and its sum parity (a
    shard's width), the cross-attention bank and the self-attention cache
    of the slot state, each once."""
    def leaves(node, path=()):
        if isinstance(node, dict):
            return [t for k, v in node.items() for t in leaves(v, path + (k,))]
        return [] if path[:2] in (("cross", "wk"), ("cross", "wv")) \
            else [node]
    head = stepper.params["lm_head"]["w"]
    return float(sum(t.numel() * t.element_size()
                     for t in leaves(stepper.params["dec_layers"])
                     + leaves(state))
                 + head.numel() * head.element_size()
                 * (1 + 1 / stepper.n_shards))


def _family_scheduler(tag: str, cfg, model, params, argv: list[str],
                      n_leaves: int, least_bytes) -> dict:
    """A full-width model through launch.serve's scheduler (``argv``: 4
    slots, 8 requests, prompt 16, 16 new tokens) fault-free with --perf
    and under --chaos: every request completes with the fault-free tokens,
    the counters equal the same runs' at smoke size on the CPU, kernel 4
    launches ``n_leaves`` times per encode, kernel 6 ``norms_per_pass``
    times per round and prefill, and the perf line's fused-round bound is
    within 5% of ``least_bytes(stepper, state)`` over the HBM rate."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import TPCtx, build
    runs_args = {"fault-free": [], "chaos": ["--chaos", CHAOS]}
    obs_args = {"fault-free": ["--perf"], "chaos": []}   # the card's runs
    cfg_cpu = smoke_config(cfg)
    m_cpu = build(cfg_cpu, TPCtx(tp=T, mode="coded", code_r=R,
                                 moe_capacity=0))
    p_cpu = m_cpu.init(0, device="cpu")
    want = {name: dict(_scheduler_run(m_cpu, p_cpu, argv + extra,
                                      "cpu")[1].metrics.counters)
            for name, extra in runs_args.items()}
    wrappers = _kernel_wrappers()
    runs = {}
    for name, extra in runs_args.items():
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stepper, sched, done, obs = _scheduler_run(
            model, params, argv + extra + obs_args[name], "cuda",
            report=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        c = dict(sched.metrics.counters)
        launches = {k: fn.launches for k, fn in wrappers.items()}
        passes = sched.executor.vstep.n_dispatches + c["requests_admitted"]
        res = {"tokens": {q.rid: list(q.tokens) for q in done},
               "counters": c, "seconds": secs, "launches": launches,
               "round_ms": float(np.median(sched.executor.round_ms)),
               "graphs": _check_scheduler_graphs(f"{tag} {name}", sched,
                                                 stepper, T)}
        if "--perf" in obs_args[name]:
            least = least_bytes(stepper, sched.executor.state)
            res.update(_check_observability("fault-free", sched, stepper,
                                            obs, obs_args[name],
                                            least_bytes=least))
            res["least_bytes"] = least
        if len(done) != 8 or any(len(q.tokens) != 16 for q in done) or \
                c != want[name]:
            raise AssertionError(f"{tag} {name}: {len(done)}/8 completed, "
                                 f"counters {c} vs the CPU run's "
                                 f"{want[name]}")
        if len(_parity_leaves(stepper.params)) != n_leaves or \
                launches["cdc_encode"] != \
                n_leaves * (1 + c["parity_reencodes"]) or \
                launches["rmsnorm"] != norms_per_pass(cfg) * passes or not (
                    launches["cdc_coded_matmul"]
                    and launches["cdc_fused_head_argmax"]):
            raise AssertionError(f"{tag} {name}: launches {launches} "
                                 f"({len(_parity_leaves(stepper.params))} "
                                 f"parity leaves, {c['parity_reencodes']} "
                                 f"re-encodes, {passes} passes)")
        if name != "fault-free" and \
                res["tokens"] != runs["fault-free"]["tokens"]:
            raise AssertionError(f"{tag} {name}: token streams differ "
                                 f"from the fault-free run")
        runs[name] = res
        log(f"{tag} scheduler {name}: 8/8 completed, {c['decode_rounds']}"
            f" rounds in {secs:.2f} s, round_ms median {res['round_ms']:.3f}"
            f", {c['erasures_recovered']} recovered in-step, "
            f"{c['beyond_budget_failures']} beyond budget, "
            f"{c['requests_requeued']} requeued, {c['parity_reencodes']} "
            f"re-encodes, counters equal to the CPU run's, launches "
            f"{launches}")
        del stepper, sched, done
    chaos = runs["chaos"]["counters"]
    if not (chaos["erasures_recovered"] and chaos["beyond_budget_failures"]
            and chaos["parity_reencodes"]):
        raise AssertionError(f"{tag} chaos run lacks a recovery, a requeue "
                             f"or a re-encode: {chaos}")
    return runs


def _whisper_scheduler(cfg, model, params) -> dict:
    """(a) whisper-medium through launch.serve's scheduler (4 slots, 8
    requests with fresh frames, prompt 16, 16 new tokens) fault-free with
    --perf and under chaos (``_family_scheduler``): 12 kernel-4 launches
    per encode, kernel 6 never, and the perf line's fused-round bound
    within 5% of the weights, bank and cache bytes the round must read."""
    return _family_scheduler("whisper", cfg, model, params, WHISPER_ARGS,
                             12, _whisper_round_bytes)


def _admission_ms(eng, batch, n: int = 3) -> dict:
    """Wall ms of one request's encoder and cross K/V (``init_decode``)
    and of its whole admission (the prompt's prefill too), medians of
    ``n``, each ended by a synchronise."""
    from repro_torch.runtime.executor import request_batch
    st = eng.stepper
    one = request_batch(batch["tokens"][0], {"frames": batch["frames"][0]})
    v = st._mask(eng.valid)
    out = {"encoder_and_cross_kv": [], "admission": []}
    for _ in range(n):
        for key, fn in (("encoder_and_cross_kv", lambda: st.model.init_decode(
                st.params, one, 1, st.max_len, st.cache_dtype, valid=v)),
                        ("admission", lambda: st.prefill(one, eng.valid))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[key].append((time.perf_counter() - t0) * 1e3)
    return {k: float(np.median(v)) for k, v in out.items()}


def serve_whisper() -> dict:
    """whisper-medium at full width in ``WHISPER_LAYERS`` + ``WHISPER_LAYERS``
    of its 24 + 24 layers (d 1024, 16/16 heads,
    d_ff 4096, vocab 51865, 1500 frames; float32, T = 4, r = 2 folded,
    seeded random weights and frames). (a) ``_whisper_scheduler``. (b) One
    batch of 4 through ServingEngine.generate with frames, fault-free and
    with shard 2 killed at step 4, on graph rounds, eager fused rounds,
    the reference variant and kernel-free (the reference variant on parity
    encoded by kernel 4's plain version: no kernel at all): identical
    streams; each fused round launches kernel 1 5 times a layer (self wq, wk,
    wv, cross wq, w1 a layer), kernel 2 once and kernel 6 never, one
    graph is captured per (encode generation, mask) and replayed per fused
    round; the engine's encode launches kernel 4 12 times; every fused
    round's max logit (kernel 2's) within 1e-4 of the reference round's.
    (c) The device
    ms per round by kernel, the idle share, the round medians, the
    admission time (encoder and cross K/V of one request) and peak
    memory."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import cdc_encode, ops
    from repro_torch.models import TPCtx, build
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = dataclasses.replace(get_arch(WHISPER), n_layers=WHISPER_LAYERS,
                              encoder_layers=WHISPER_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R))
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sched = _whisper_scheduler(cfg, model, params)
    torch.cuda.empty_cache()
    scfg = ServeConfig(max_len=16 + N_TOK + 8, batch=4,
                       cache_dtype=torch.float32)
    batch = model.dummy_batch(np.random.default_rng(0), 4, 16)
    rounds, dead = N_TOK - 1, 2
    down = f"shard {dead} dead"
    cdc_encode.cdc_encode.launches = 0
    eng = ServingEngine(model, params, scfg, use_fused=True,
                        use_graphs=True)
    k4 = cdc_encode.cdc_encode.launches
    recs = {}
    with recorded_rounds() as recs["graph"]:
        runs = {"graph": _serve_run(eng, batch)}
        runs[f"graph, {down}"] = _serve_run(eng, batch, fail_at={4: dead})
    for name in ("graph", f"graph, {down}"):
        _check_graph_run(f"whisper {name}", runs[name], 1)
    eng.valid = np.ones(T, bool)
    med = {"graph": float(np.median(runs["graph"]["round_ms"]))}
    prof = {"graph": profile_rounds(eng.executor(4), eng.valid,
                                    med["graph"])}
    admission = _admission_ms(eng, batch)
    eng.use_graphs = False
    runs["eager"] = _serve_run(eng, batch)
    runs[f"eager, {down}"] = _serve_run(eng, batch, fail_at={4: dead})
    for name in ("eager", f"eager, {down}"):
        _check_eager_run(f"whisper {name}", runs[name])
    eng.valid = np.ones(T, bool)
    med["eager"] = float(np.median(runs["eager"]["round_ms"]))
    prof["eager"] = profile_rounds(eng.executor(4), eng.valid, med["eager"])
    del eng
    torch.cuda.empty_cache()
    ref_eng = ServingEngine(model, params, scfg, use_fused=False)
    with recorded_rounds() as recs["reference"]:
        runs["reference"] = _serve_run(ref_eng, batch)
        runs[f"reference, {down}"] = _serve_run(ref_eng, batch,
                                                fail_at={4: dead})
    del ref_eng
    torch.cuda.empty_cache()
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    encode = ops.cdc_encode
    ops.cdc_encode = cdc_encode.encode_plain
    try:
        free_eng = ServingEngine(model, params, scfg, use_fused=False)
    finally:
        ops.cdc_encode = encode
    runs["kernel-free"] = _serve_run(free_eng, batch)
    runs[f"kernel-free, {down}"] = _serve_run(free_eng, batch,
                                              fail_at={4: dead})
    free_launches = {k: fn.launches for k, fn in wrappers.items()}
    del free_eng
    clean = runs["graph"]
    for name, res in runs.items():
        if name.startswith(("graph", "eager")):
            _check_launches(f"whisper {name}", res, cfg, rounds, norms=False)
        elif res["k1"] or res["k2"]:
            raise AssertionError(f"whisper {name} launched a coded kernel")
        if res["k6"]:
            raise AssertionError(f"whisper {name} launched kernel 6")
        if not np.array_equal(res["tokens"], clean["tokens"]):
            raise AssertionError(f"whisper {name} tokens differ from the "
                                 f"fault-free graph run:\n{res['tokens']}\n"
                                 f"vs\n{clean['tokens']}")
    if any(free_launches.values()):
        raise AssertionError(f"the whisper kernel-free runs launched "
                             f"{free_launches}")
    # every fused round's max logit (kernel 2's own) against the reference
    # round's. At random init the reference's embeddings (0.02) are 35x
    # below the sinusoidal positions, and at this depth every stream settles
    # on one token whatever its prompt: the logits still carry every layer
    fused_max = torch.stack([m for _, m in recs["graph"]["fused"]])
    ref_max = torch.stack([lg.max(-1).values
                           for lg in recs["reference"]["reference"]])
    torch.testing.assert_close(fused_max, ref_max, **TOL)
    max_err = float((fused_max - ref_max).abs().max())
    distinct = len(np.unique(clean["tokens"]))
    if k4 != 12:
        raise AssertionError(f"whisper engine: {k4} encode launches (12 "
                             f"parity leaves)")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    meds = {n: float(np.median(r["round_ms"])) for n, r in runs.items()}
    idle = {k: (1 - p["device_ms"] / med[k]) if p else None
            for k, p in prof.items()}
    log(f"served whisper-medium at full width (params in {init_s:.1f} s): "
        f"identical streams on graph and eager fused rounds, the reference "
        f"variant and kernel-free, fault-free and with shard {dead} erased "
        f"at step 4; per fused round {clean['k1'] // rounds} coded-GEMM "
        f"({clean['k1_variants']}) + {clean['k2'] // rounds} head "
        f"({clean['k2_variants']}) + {clean['k6']} rmsnorm launches; "
        f"{k4} encode launches per encode; every fused round's max logit "
        f"within 1e-4 of the reference round's ({fused_max.numel()} rows, "
        f"max abs err {max_err:.3e}; {distinct} distinct tokens in the "
        f"streams); round medians {meds} ms; idle "
        f"share graph {idle['graph']} / eager {idle['eager']}; admission "
        f"{admission} ms; max_memory_allocated {peak:.2f} GiB")
    log("whisper first stream:", clean["tokens"][0].tolist())
    return {"k1": clean["k1"], "k2": clean["k2"], "k6": clean["k6"],
            "k4_per_encode": k4, "round_ms": meds, "profile": prof,
            "max_logit_err": max_err, "distinct_tokens": distinct,
            "idle_share": idle, "admission_ms": admission,
            "peak_gib": peak, "init_s": init_s, "scheduler": sched,
            "vstep": {n: r["vstep"] for n, r in runs.items()}}


# ------------------------------------------------------------ phase 14 ----

XLSTM_ARGS = ["--arch", XLSTM, "--coded", "--tp", str(T), "--batch", "4",
              "--requests", "8", "--arrival-gap-ms", "2", "--prompt-len",
              "16", "--gen-tokens", "16", "--seed", str(CHAOS_SEED)]
# the batch's prompt: prefill takes the chunkwise mLSTM form over 3 chunks
# of 128 (the last padded by 84) and 300 sLSTM steps
XLSTM_PROMPT = 300
# passes of the plain mLSTM decode step over its memory C [B, nh, dh, dh]:
# read and written by the scale, read and written by the rank-1 write,
# read by the readout (one fused pass would read and write it once: 2)
MLSTM_MEMORY_PASSES = 5


def _xlstm_round_bytes(stepper, state) -> float:
    """Bytes a fused xLSTM round moves at the least, as the port's plain
    recurrences run it: every block weight and parity leaf, the LM head
    and its sum parity (a shard's width), the mLSTM memories
    ``MLSTM_MEMORY_PASSES`` times and every other block-state leaf read
    and written once."""
    def leaves(node):
        if isinstance(node, dict):
            node = list(node.values())
        if isinstance(node, list):
            return [t for v in node for t in leaves(v)]
        return [node]

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    head = stepper.params["lm_head"]["w"]
    memory = [b["c"] for b in state["blocks"] if b["c"].dim() == 4]
    rest = [t for b in state["blocks"] for key, t in b.items()
            if key != "c" or t.dim() != 4]
    return float(nbytes(leaves(stepper.params["blocks"]))
                 + nbytes([head]) * (1 + 1 / stepper.n_shards)
                 + MLSTM_MEMORY_PASSES * nbytes(memory) + 2 * nbytes(rest))


def _xlstm_scheduler(cfg, model, params) -> dict:
    """(a) xlstm-125m through launch.serve's scheduler (4 slots, 8
    requests, prompt 16, 16 new tokens) fault-free with --perf and under
    chaos (``_family_scheduler``): 46 kernel-4 launches per encode (44
    mLSTM leaves, wx, the head), kernel 6 once a round and a prefill, and
    the perf line's fused-round bound within 5% of ``_xlstm_round_bytes``
    over the HBM rate."""
    return _family_scheduler("xlstm", cfg, model, params, XLSTM_ARGS,
                             coded_gemms(cfg) + 1, _xlstm_round_bytes)


def _prefill_ms(eng, prompt, n: int = 3) -> float:
    """Wall ms of one request's admission prefill (``prompt`` through the
    reference variant into a fresh block state), median of ``n``, each
    ended by a synchronise."""
    from repro_torch.runtime.executor import request_batch
    one = request_batch(prompt)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.stepper.prefill(one, eng.valid)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _state_leaves(state) -> list[torch.Tensor]:
    """Every tensor of a decode state (dicts and xLSTM's block list), in a
    fixed order."""
    if isinstance(state, dict):
        return [t for k in sorted(state) for t in _state_leaves(state[k])]
    if isinstance(state, list):
        return [t for v in state for t in _state_leaves(v)]
    return [state]


def _two_dead_between_replays(tag: str, cfg, params, prompts) -> dict:
    """The dedicated layout at r = 2 (two dead shards in budget) on two
    4-slot pools, graph and eager fused rounds, masks all valid, all
    valid, shard 2 dead, shards 1 and 2 dead, shard 2 dead, all valid,
    all valid: the 2-dead round takes the eager reference variant on both
    pools and writes the state in place (every leaf of the graph pool's
    state keeps its address), and the replays after it give the eager
    rounds' tokens; the states end equal to the bit."""
    from repro_torch.models import TPCtx, build
    from repro_torch.runtime.executor import SlotPoolExecutor
    from repro_torch.serve import ModelStepper
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R,
                             code_layout="dedicated"))
    stepper = ModelStepper(model, params, max_len=64)
    full = np.ones(T, bool)
    one = full.copy()
    one[2] = False
    two = one.copy()
    two[1] = False
    masks = [full, full, one, two, one, full, full]
    out = {}
    for graphs in (True, False):
        ex = SlotPoolExecutor(stepper, 4, overlap=False, use_fused=True,
                              use_graphs=graphs)
        first = [ex.admit(i, p[:16], full, tag=i) for i, p in
                 enumerate(prompts)]
        ptrs = [t.data_ptr() for t in _state_leaves(ex.state)]
        toks, variants = [first], []
        for valid in masks:
            toks.append([tok for _, _, tok in ex.step_round(valid)])
            variants.append(ex.vstep.last_variant)
        out[graphs] = {"tokens": toks, "variants": variants,
                       "replays": ex.vstep.n_replays, "state": ex.state,
                       "in_place": ptrs == [t.data_ptr() for t in
                                            _state_leaves(ex.state)]}
    g, e = out[True], out[False]
    want = ["fused"] * 3 + ["reference"] + ["fused"] * 3
    same = all(torch.equal(a, b) for a, b in zip(_state_leaves(g["state"]),
                                                 _state_leaves(e["state"])))
    if g["tokens"] != e["tokens"] or g["variants"] != want or \
            e["variants"] != want or g["replays"] != 6 or not same or \
            not (g["in_place"] and e["in_place"]):
        raise AssertionError(f"{tag} 2-dead round between replays: tokens "
                             f"{g['tokens']} vs eager {e['tokens']}, "
                             f"variants {g['variants']} / {e['variants']}, "
                             f"{g['replays']} replays, states equal {same}, "
                             f"in place {g['in_place']} / {e['in_place']}")
    log(f"{tag} dedicated r = 2: a 2-dead reference round between graph "
        f"replays leaves the state's own tensors; the replays after it "
        f"give the eager rounds' tokens {g['tokens'][-1]}, states equal to "
        f"the bit")
    return {"tokens": g["tokens"], "variants": g["variants"],
            "replays": g["replays"]}


def _serve_one_batch(tag: str, cfg, model, params, prompt_len: int,
                     n_leaves: int, on_engine=None) -> dict:
    """(b) and (d) of phases 14 and 15: one batch of 4 seeded prompts of
    ``prompt_len`` tokens and 16 new tokens through ServingEngine.generate,
    fault-free and with shard 2 killed at step 4, on graph rounds, eager
    fused rounds, the reference variant and kernel-free (the reference
    variant with plain norms on parity encoded by kernel 4's plain version:
    no kernel at all): identical streams; each fused round launches kernel
    1 ``coded_gemms`` times, kernel 2 once and kernel 6 ``norms_per_pass``
    times (and every prefill), one graph is captured per (encode
    generation, mask) and replayed per fused round; the engine's encode
    launches kernel 4 ``n_leaves`` times; every fused round's max logit
    (kernel 2's) within 1e-4 of the reference round's. ``on_engine(eng)``
    runs on the graph engine after its runs. Also the device ms per round
    by kernel, the idle share, the round medians and the admission
    prefill time."""
    from repro_torch.kernels import cdc_encode, ops, ref
    from repro_torch.models import transformer
    from repro_torch.serve import ServeConfig, ServingEngine
    scfg = ServeConfig(max_len=prompt_len + N_TOK + 8, batch=4,
                       cache_dtype=torch.float32)
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab, (4, prompt_len))}
    rounds, dead = N_TOK - 1, 2
    down = f"shard {dead} dead"
    cdc_encode.cdc_encode.launches = 0
    eng = ServingEngine(model, params, scfg, use_fused=True,
                        use_graphs=True)
    k4 = cdc_encode.cdc_encode.launches
    recs = {}
    with recorded_rounds() as recs["graph"]:
        runs = {"graph": _serve_run(eng, batch)}
        runs[f"graph, {down}"] = _serve_run(eng, batch, fail_at={4: dead})
    for name in ("graph", f"graph, {down}"):
        _check_graph_run(f"{tag} {name}", runs[name], 1)
    eng.valid = np.ones(T, bool)
    med = {"graph": float(np.median(runs["graph"]["round_ms"]))}
    prof = {"graph": profile_rounds(eng.executor(4), eng.valid,
                                    med["graph"])}
    admission_ms = _prefill_ms(eng, batch["tokens"][0])
    extra = on_engine(eng) if on_engine is not None else None
    eng.use_graphs = False
    runs["eager"] = _serve_run(eng, batch)
    runs[f"eager, {down}"] = _serve_run(eng, batch, fail_at={4: dead})
    for name in ("eager", f"eager, {down}"):
        _check_eager_run(f"{tag} {name}", runs[name])
    eng.valid = np.ones(T, bool)
    med["eager"] = float(np.median(runs["eager"]["round_ms"]))
    prof["eager"] = profile_rounds(eng.executor(4), eng.valid, med["eager"])
    del eng
    torch.cuda.empty_cache()
    ref_eng = ServingEngine(model, params, scfg, use_fused=False)
    with recorded_rounds() as recs["reference"]:
        runs["reference"] = _serve_run(ref_eng, batch)
        runs[f"reference, {down}"] = _serve_run(ref_eng, batch,
                                                fail_at={4: dead})
    med["reference"] = float(np.median(runs["reference"]["round_ms"]))
    del ref_eng
    torch.cuda.empty_cache()
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    encode, norm = ops.cdc_encode, transformer.rmsnorm
    ops.cdc_encode = cdc_encode.encode_plain
    transformer.rmsnorm = lambda p, x, eps: ref.rmsnorm_ref(x, p["g"], eps)
    try:
        free_eng = ServingEngine(model, params, scfg, use_fused=False)
        runs["kernel-free"] = _serve_run(free_eng, batch)
        runs[f"kernel-free, {down}"] = _serve_run(free_eng, batch,
                                                  fail_at={4: dead})
    finally:
        ops.cdc_encode, transformer.rmsnorm = encode, norm
    free_launches = {k: fn.launches for k, fn in wrappers.items()}
    del free_eng
    torch.cuda.empty_cache()
    clean = runs["graph"]
    for name, res in runs.items():
        if name.startswith(("graph", "eager")):
            _check_launches(f"{tag} {name}", res, cfg, rounds, norms=True)
        elif res["k1"] or res["k2"]:
            raise AssertionError(f"{tag} {name} launched a coded kernel")
        if not np.array_equal(res["tokens"], clean["tokens"]):
            raise AssertionError(f"{tag} {name} tokens differ from the "
                                 f"fault-free graph run:\n{res['tokens']}\n"
                                 f"vs\n{clean['tokens']}")
    if any(free_launches.values()):
        raise AssertionError(f"the {tag} kernel-free runs launched "
                             f"{free_launches}")
    if k4 != n_leaves:
        raise AssertionError(f"{tag} engine: {k4} encode launches "
                             f"({n_leaves} parity leaves)")
    # every fused round's max logit (kernel 2's own) against the reference
    # round's: random-init streams may settle on one token
    fused_max = torch.stack([m for _, m in recs["graph"]["fused"]])
    ref_max = torch.stack([lg.max(-1).values
                           for lg in recs["reference"]["reference"]])
    torch.testing.assert_close(fused_max, ref_max, **TOL)
    meds = {n: float(np.median(r["round_ms"])) for n, r in runs.items()}
    return {"clean": clean, "prompts": batch["tokens"], "k4": k4,
            "round_ms": meds, "profile": prof,
            "idle_share": {k: (1 - p["device_ms"] / med[k]) if p else None
                           for k, p in prof.items()},
            "max_logit_err": float((fused_max - ref_max).abs().max()),
            "rows": fused_max.numel(),
            "distinct_tokens": len(np.unique(clean["tokens"])),
            "admission_ms": admission_ms, "on_engine": extra,
            "vstep": {n: r["vstep"] for n, r in runs.items()}}


def _summary(one: dict) -> dict:
    """What a family phase returns of ``_serve_one_batch``'s result."""
    clean = one["clean"]
    return {"k1": clean["k1"], "k2": clean["k2"], "k6": clean["k6"],
            "k4_per_encode": one["k4"],
            **{k: one[k] for k in ("round_ms", "profile", "max_logit_err",
                                   "distinct_tokens", "idle_share",
                                   "admission_ms", "vstep")}}


def _served_line(tag: str, cfg, one: dict, what: str, init_s: float,
                 peak: float):
    clean, rounds = one["clean"], N_TOK - 1
    log(f"served {cfg.name} at full width (params in {init_s:.1f} s): "
        f"identical streams on graph and eager fused rounds, the reference "
        f"variant and kernel-free, fault-free and with shard 2 erased at "
        f"step 4, after {what}; per fused round {clean['k1'] // rounds} "
        f"coded-GEMM ({clean['k1_variants']}) + {clean['k2'] // rounds} "
        f"head ({clean['k2_variants']}) + {norms_per_pass(cfg)} rmsnorm "
        f"launches; {one['k4']} encode launches per encode; every fused "
        f"round's max logit within 1e-4 of the reference round's "
        f"({one['rows']} rows, max abs err {one['max_logit_err']:.3e}; "
        f"{one['distinct_tokens']} distinct tokens in the streams); round "
        f"medians {one['round_ms']} ms; idle share graph "
        f"{one['idle_share']['graph']} / eager {one['idle_share']['eager']}"
        f"; admission prefill {one['admission_ms']:.3f} ms; "
        f"max_memory_allocated {peak:.2f} GiB")
    log(f"{tag} first stream:", clean["tokens"][0].tolist())


def _init_full_width(cfg):
    """The coded model (T = 4, r = 2 folded; an MoE at capacity 0, as
    launch.serve builds it) and its seeded float32 params on the card, and
    the seconds the init took."""
    from repro_torch.models import TPCtx, build
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R, moe_capacity=0))
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    return model, params, time.perf_counter() - t0


def serve_xlstm(cfg=None) -> dict:
    """xlstm-125m at full width (12 blocks, xLSTM[7:1]: sLSTM at block 7;
    d 768, 4 heads, up-projection 1536, head width 384, vocab 50304;
    float32, T = 4, r = 2 folded, seeded random weights). (a)
    ``_xlstm_scheduler``. (b) ``_serve_one_batch`` with a 300-token
    prompt: 45 kernel-1 launches a fused round (up, wq, wk, wv of 11
    mLSTM blocks, wx of the sLSTM), kernel 2 once and kernel 6 once (the
    final norm), 46 kernel-4 launches an encode. (c) A 2-dead round
    between replays (``_two_dead_between_replays``). (d) Peak memory and
    the perf count beside the least one with a fused mLSTM step."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    cfg = cfg or get_arch(XLSTM)
    torch.cuda.reset_peak_memory_stats()
    model, params, init_s = _init_full_width(cfg)
    sched = _xlstm_scheduler(cfg, model, params)
    torch.cuda.empty_cache()
    one = _serve_one_batch("xlstm", cfg, model, params, XLSTM_PROMPT,
                           coded_gemms(cfg) + 1)
    two_dead = _two_dead_between_replays("xlstm", cfg, params,
                                         one["prompts"])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    perf = sched["fault-free"]
    # the least count with one fused pass over the mLSTM memories (read
    # and written once) beside the plain step's
    memory = sum(4 * 4 * cfg.n_heads * (2 * cfg.d_model // cfg.n_heads) ** 2
                 for kind in transformer.xlstm_block_kinds(cfg)
                 if kind == "mlstm")
    least = {"plain_step": perf["least_bytes"],
             "fused_step": perf["least_bytes"]
             - (MLSTM_MEMORY_PASSES - 2) * memory, "mlstm_memory": memory}
    fused = perf["perf"]["fused"]
    log(f"xlstm perf: fused-round bound {fused['bound_step_s'] * 1e3:.4f} "
        f"ms on {fused['bytes'] / 1e9:.4f} GB counted; least "
        f"bytes {least['plain_step'] / 1e9:.4f} GB as the plain step runs "
        f"({MLSTM_MEMORY_PASSES} passes over {memory / 1e6:.2f} MB of mLSTM "
        f"memory), {least['fused_step'] / 1e9:.4f} GB with one fused pass "
        f"({least['fused_step'] / HBM_BYTES_PER_S * 1e3:.4f} ms at the HBM "
        f"rate)")
    _served_line("xlstm", cfg, one, f"a {XLSTM_PROMPT}-token prefill",
                 init_s, peak)
    return {**_summary(one), "peak_gib": peak, "init_s": init_s,
            "scheduler": sched, "two_dead": two_dead, "least_bytes": least}


# ------------------------------------------------------------ phase 15 ----

HYMBA_ARGS = ["--arch", HYMBA, "--coded", "--tp", str(T), "--batch", "4",
              "--requests", "8", "--arrival-gap-ms", "2", "--prompt-len",
              "16", "--gen-tokens", "16", "--seed", str(CHAOS_SEED)]
# the batch's prompt: with 16 new tokens max_len passes the 1024-token
# window, so the ring holds 1024 entries and decode wraps it
HYMBA_PROMPT = 1016
HYMBA_LAYERS = 16          # of 32 (full width); see QWEN2_LAYERS


def _hymba_least(stepper, state) -> dict:
    """The parts of what a fused hymba round moves at the least, as the
    port's plain mamba step runs it: every layer weight and parity leaf
    (the mamba branch's too), the LM head and its sum parity (a shard's
    width), the KV cache (k, v, positions, lengths) read once, the SSM
    state ``mamba.STEP_STATE_PASSES`` times and the conv window read and
    written."""
    from repro_torch.models.mamba import STEP_STATE_PASSES

    def nbytes(ts):
        return float(sum(t.numel() * t.element_size() for t in ts))

    head = stepper.params["lm_head"]["w"]
    ssm, conv = state["mamba"]["ssm"], state["mamba"]["conv"]
    return {"weights": nbytes(_state_leaves(stepper.params["layers"]))
            + nbytes([head]) * (1 + 1 / stepper.n_shards),
            "kv": nbytes(_state_leaves(state["kv"])),
            "ssm_pass": nbytes([ssm]),
            "mamba": STEP_STATE_PASSES * nbytes([ssm]) + 2 * nbytes([conv])}


def _hymba_round_bytes(stepper, state) -> float:
    """The sum of ``_hymba_least``'s parts."""
    parts = _hymba_least(stepper, state)
    return parts["weights"] + parts["kv"] + parts["mamba"]


def _hymba_scheduler(cfg, model, params) -> dict:
    """(a) hymba-1.5b through launch.serve's scheduler (4 slots, 8
    requests, prompt 16, 16 new tokens) fault-free with --perf and under
    chaos (``_family_scheduler``): 7 kernel-4 launches per encode (wq,
    wk, wv, in_proj, w1, w3 stacked over the layers, the head), kernel 6
    65 times a round and a prefill, and the perf line's fused-round bound
    within 5% of ``_hymba_round_bytes`` over the HBM rate."""
    return _family_scheduler("hymba", cfg, model, params, HYMBA_ARGS,
                             coded_gemms(cfg) // cfg.n_layers + 1,
                             _hymba_round_bytes)


def _hymba_window_perf(eng) -> dict:
    """The perf counter's fused round on the batch's slot state (the
    1024-entry window full after the prompt): every launch costed, the
    bound within 5% of ``_hymba_round_bytes`` (weights, window, mamba
    state) over the HBM rate."""
    from repro_torch.models.mamba import STEP_STATE_PASSES
    from repro_torch.obs.perf import attribute_round_costs
    ex = eng.executor(4)
    fused = attribute_round_costs(ex.vstep, ex.state, ex.last_toks)["fused"]
    parts = _hymba_least(eng.stepper, ex.state)
    least = _hymba_round_bytes(eng.stepper, ex.state)
    want = least / HBM_BYTES_PER_S * 1e3
    got = fused.bound_step_s * 1e3
    if fused.custom_calls_uncosted or fused.dominant != "memory" or \
            abs(got / want - 1) > PERF_BOUND_TOL:
        raise AssertionError(f"hymba perf over the window: {fused} (least "
                             f"bytes {least / 1e9:.4f} GB, {want:.4f} ms)")
    log(f"hymba perf over the 1024-entry window: fused-round bound "
        f"{got:.4f} ms on {fused.bytes / 1e9:.4f} GB counted "
        f"({fused.flops / 1e9:.3f} GFLOP, {fused.useful_flops / 1e9:.3f} "
        f"useful); least bytes {least / 1e9:.4f} GB ({want:.4f} ms): "
        f"weights {parts['weights'] / 1e9:.4f} GB, KV window "
        f"{parts['kv'] / 1e9:.4f} GB, SSM state "
        f"{parts['ssm_pass'] / 1e6:.2f} MB a pass x {STEP_STATE_PASSES}")
    return {"bound_ms": got, "bytes": fused.bytes, "least_bytes": least,
            "least_ms": want, "flops": fused.flops,
            "useful_flops": fused.useful_flops, **parts}


def serve_hymba(cfg=None) -> dict:
    """hymba-1.5b at full width in ``HYMBA_LAYERS`` of its 32 layers (SWA
    attention, window 1024, beside a mamba branch; d 1600, 25/5 heads of
    64 run as 28/7, d_ff 5504, vocab 32001, SSM state 16; float32, T = 4,
    r = 2 folded, seeded random weights). (a) ``_hymba_scheduler``. (b)
    ``_serve_one_batch`` with a 1016-token prompt (the ring of 1024 wraps
    in decode): 6 kernel-1 launches a layer a fused round (wq, wk, wv,
    in_proj, w1, w3), none on the row-copy instantiation, kernel 2 once
    and kernel 6 2L + 1 times, 7 kernel-4 launches an encode; the perf
    count of a fused round over the full window (``_hymba_window_perf``).
    (c) A 2-dead round between replays. (d) Peak memory."""
    from repro_torch.configs import get_arch
    cfg = cfg or dataclasses.replace(get_arch(HYMBA), n_layers=HYMBA_LAYERS)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, params, init_s = _init_full_width(cfg)
    sched = _hymba_scheduler(cfg, model, params)
    torch.cuda.empty_cache()
    one = _serve_one_batch("hymba", cfg, model, params, HYMBA_PROMPT,
                           coded_gemms(cfg) // cfg.n_layers + 1,
                           on_engine=_hymba_window_perf)
    copied = [v for v in one["clean"]["k1_variants"] if "rowcopy" in v]
    if copied:
        raise AssertionError(f"hymba: kernel 1 took the row-copy "
                             f"instantiation: "
                             f"{one['clean']['k1_variants']}")
    two_dead = _two_dead_between_replays("hymba", cfg, params,
                                         one["prompts"])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _served_line("hymba", cfg, one, f"a {HYMBA_PROMPT}-token prefill "
                 f"(the 1024-entry window wraps in decode)", init_s, peak)
    secs = time.perf_counter() - t0
    log(f"phase 15 (hymba-1.5b) took {secs:.1f} s")
    return {**_summary(one), "peak_gib": peak, "init_s": init_s,
            "scheduler": sched, "two_dead": two_dead,
            "window_perf": one["on_engine"], "seconds": secs}


# ------------------------------------------------------------ phase 16 ----

QWEN2 = "qwen2-moe-a2.7b"
QWEN3 = "qwen3-moe-235b-a22b"
# of 94: a float32 layer holds ~10 GB (128 experts of 3 x 4096 x 1536
# weights), so 94 would need ~0.9 TB; 4 with the embedding, the head and
# its parity take ~46 GB
QWEN3_LAYERS = 4
# qwen2-moe in 12 of its 24 layers, hymba in 16 of 32, whisper in 12 + 12
# of 24 + 24 (full width): the whole smoke must fit its time on a slow host
QWEN2_LAYERS = 12
MOE_ARGS = ["--arch", QWEN2, "--coded", "--tp", str(T), "--batch", "4",
            "--requests", "8", "--arrival-gap-ms", "2", "--prompt-len",
            "16", "--gen-tokens", "16", "--seed", str(CHAOS_SEED)]
MOE_PROMPT = 64
# passes of the routed experts' dense dispatch over its buffers: the
# [E * cap + 1, D] slots written by the zero fill, read by the two first
# products, and the [E, cap, D] output written by the third (4); the
# [E, cap, fe] hidden written by the first product, read and written by
# the SiLU, written by the second, read twice and written by the gate's
# product, read by the third (8)
MOE_BUFFER_PASSES, MOE_HIDDEN_PASSES = 4, 8


def moe_shapes(cfg, gemms: tuple) -> dict:
    """Kernel 1's (k, m_l) at the named coded GEMMs of an MoE at T = 4
    (attention's wq, wk, wv; the shared experts' w1, w3, ``n_shared_experts
    * d_ff_expert`` wide), kernel 2's head (k, m_l, vocab) and kernel 4's
    every parity leaf (stacked over the layers; the head): qwen2-moe's wq
    m_l 512 and w1 1408 at k 2048, qwen3-moe's wq 2048 and wk 128 at k
    4096, both heads' 151936 words at m_l 37984."""
    from repro_torch.models.attention import attn_dims
    from repro_torch.models.common import TPCtx
    ctx, d, L = TPCtx(tp=T), cfg.d_model, cfg.n_layers
    hq, hkv, _ = attn_dims(cfg, T)
    width = {"wq": hq * cfg.hd, "wk": hkv * cfg.hd, "wv": hkv * cfg.hd}
    if cfg.n_shared_experts:
        width["w1"] = width["w3"] = cfg.n_shared_experts * cfg.d_ff_expert
    m_l = {n: ctx.pad_dim(m) // T for n, m in width.items()}
    head = ctx.pad_dim(cfg.vocab) // T
    return {"gemms": {n: (d, m_l[n]) for n in gemms},
            "head": (d, head, cfg.vocab),
            "encode": [(L, d, T * m) for m in m_l.values()]
            + [(d, T * head)]}


def _moe_cfgs() -> dict:
    """qwen2-moe at full width in ``QWEN2_LAYERS`` of its 24 layers,
    qwen3-moe at full width in ``QWEN3_LAYERS`` of its 94, with the GEMMs
    phase 16 checks and times at each."""
    import dataclasses
    from repro_torch.configs import get_arch
    q3 = dataclasses.replace(get_arch(QWEN3), n_layers=QWEN3_LAYERS)
    q2 = dataclasses.replace(get_arch(QWEN2), n_layers=QWEN2_LAYERS)
    return {"qwen2": (q2, ("wq", "w1")),
            "qwen3": (q3, ("wq", "wk"))}


def _moe_least(stepper, state) -> dict:
    """The parts of what a fused MoE round moves at the least, as the
    ported ops move them: every layer weight and parity leaf (the router
    and all E experts' we1, we3 and we2: the dense dispatch's batched
    products read every expert's), the LM head and its sum parity (a
    shard's width) and the KV cache read once (the embedding's rows are
    not counted); and apart, the dispatch's buffers at the round's
    capacity (cap = n·k at capacity 0) in ``MOE_BUFFER_PASSES`` and
    ``MOE_HIDDEN_PASSES`` passes."""
    def nbytes(ts):
        return float(sum(t.numel() * t.element_size() for t in ts))

    cfg = stepper.model.cfg
    layers, head = stepper.params["layers"], stepper.params["lm_head"]["w"]
    we1 = layers["moe"]["we1"]
    n_rows = state["kv"]["len"].shape[1]
    e, cap = we1.shape[1], n_rows * cfg.top_k
    elem = we1.element_size()
    return {"weights": nbytes(_state_leaves(layers))
            + nbytes([head]) * (1 + 1 / stepper.n_shards),
            "experts": nbytes([layers["moe"][n]
                               for n in ("we1", "we3", "we2")]),
            "kv": nbytes(_state_leaves(state["kv"])),
            "dispatch": float(cfg.n_layers * elem * e * cap * (
                MOE_BUFFER_PASSES * cfg.d_model
                + MOE_HIDDEN_PASSES * cfg.d_ff_expert))}


def _moe_round_bytes(stepper, state) -> float:
    """Weights (all experts), parity and the KV cache: the bytes the
    scheduler's perf line is held to (``_moe_least`` without the
    dispatch's buffers: reckoned from the shapes, ~75 MB a qwen2 layer at
    4 slots against its 2.35 GB of weights)."""
    parts = _moe_least(stepper, state)
    return parts["weights"] + parts["kv"]


def _moe_batch_perf(eng) -> dict:
    """The perf counter's fused round on the batch's slot state: every
    launch costed, memory-bound, the bound within 5% of ``_moe_least``'s
    sum (dispatch buffers included) over the HBM rate."""
    from repro_torch.obs.perf import attribute_round_costs
    ex = eng.executor(4)
    fused = attribute_round_costs(ex.vstep, ex.state, ex.last_toks)["fused"]
    parts = _moe_least(eng.stepper, ex.state)
    least = parts["weights"] + parts["kv"] + parts["dispatch"]
    want = least / HBM_BYTES_PER_S * 1e3
    got = fused.bound_step_s * 1e3
    cfg = eng.stepper.model.cfg
    if fused.custom_calls_uncosted or fused.dominant != "memory" or \
            abs(got / want - 1) > PERF_BOUND_TOL:
        raise AssertionError(f"{cfg.name} perf of the batch's round: "
                             f"{fused} (least bytes {least / 1e9:.4f} GB, "
                             f"{want:.4f} ms)")
    log(f"{cfg.name} perf of the batch's fused round: bound {got:.4f} ms on "
        f"{fused.bytes / 1e9:.4f} GB counted ({fused.flops / 1e9:.3f} "
        f"GFLOP, {fused.useful_flops / 1e9:.3f} useful); least bytes "
        f"{least / 1e9:.4f} GB ({want:.4f} ms): weights and parity "
        f"{parts['weights'] / 1e9:.4f} GB (the routed experts "
        f"{parts['experts'] / 1e9:.4f} GB), KV cache "
        f"{parts['kv'] / 1e9:.4f} GB, dispatch buffers "
        f"{parts['dispatch'] / 1e9:.4f} GB")
    return {"bound_ms": got, "bytes": fused.bytes, "least_bytes": least,
            "least_ms": want, "flops": fused.flops,
            "useful_flops": fused.useful_flops, **parts}


def _moe_eager_split(ex, valid, n: int = 3) -> dict:
    """Device ms a fused round spends in the routed experts' batched
    products (``ffn._expert_ffn``) and in the rest of the routed path (the
    router, top-k, sorts, dispatch and combine: ``ffn._moe_local`` less
    the products), by torch.profiler over ``n`` eager fused rounds with
    the two functions in record_function ranges (a graph replay records
    no host range; an eager round launches the same kernels)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import ffn
    originals = {n: getattr(ffn, n) for n in ("_expert_ffn", "_moe_local")}

    def ranged(name, fn):
        def run(*a, **kw):
            with record_function(f"moe.{name}"):
                return fn(*a, **kw)
        return run

    graphs, ex.vstep.use_graphs = ex.vstep.use_graphs, False
    try:
        for name, fn in originals.items():
            setattr(ffn, name, ranged(name, fn))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                ex.step_round(valid)
            torch.cuda.synchronize()
    finally:
        for name, fn in originals.items():
            setattr(ffn, name, fn)
        ex.vstep.use_graphs = graphs
    ms = {name: sum(e.device_time_total for e in prof.events()
                    if e.name == f"moe.{name}"
                    and e.device_type == torch.autograd.DeviceType.CPU)
          / 1e3 / n for name in originals}
    if not ms["_expert_ffn"]:
        log("profiler: no device time under the MoE ranges; the split is "
            "not measured")
        return {}
    return {"expert_products": ms["_expert_ffn"],
            "routing": ms["_moe_local"] - ms["_expert_ffn"]}


def _moe_on_engine(eng) -> dict:
    """On the graph engine after its runs: the batch's perf count and the
    eager split of the routed path."""
    return {"perf": _moe_batch_perf(eng),
            "split": _moe_eager_split(eng.executor(4), eng.valid)}


def _moe_breakdown(tag: str, one: dict) -> dict:
    """The graph round's device time (``profile_rounds``) split into the
    routed experts' products and the routing ops (from the eager split),
    kernel 1, kernel 2 and kernel 6 (by name), and the rest."""
    prof, split = one["profile"].get("graph"), one["on_engine"]["split"]
    if not prof or not split:
        log(f"{tag} breakdown: not measured (no profiler device time)")
        return {}
    by = prof["by_kernel"]

    def named(part):
        return sum(v["ms"] for k, v in by.items() if part in k)

    out = {"device_ms": prof["device_ms"], "round_ms": prof["round_ms"],
           "expert_products": split["expert_products"],
           "routing": split["routing"],
           "kernel_1": named("coded_stream_kernel"),
           "kernel_2": named("head_stream_kernel"),
           "kernel_6": named("rmsnorm_kernel")}
    out["rest"] = out["device_ms"] - sum(
        out[k] for k in ("expert_products", "routing", "kernel_1",
                         "kernel_2", "kernel_6"))
    out["expert_share"] = out["expert_products"] / out["device_ms"]
    log(f"{tag} graph round {prof['round_ms']:.3f} ms, device busy "
        f"{prof['device_ms']:.3f} ms: routed-expert products "
        f"{out['expert_products']:.3f} ms ({out['expert_share']:.3f} of "
        f"busy), routing {out['routing']:.3f}, kernel 1 "
        f"{out['kernel_1']:.3f}, kernel 2 {out['kernel_2']:.3f}, kernel 6 "
        f"{out['kernel_6']:.3f}, the rest {out['rest']:.3f}")
    return out


def _serve_moe_model(tag: str, cfg, scheduler: bool) -> dict:
    """One MoE at full width (float32, T = 4, r = 2 folded, capacity 0,
    seeded random weights): with ``scheduler``, launch.serve's scheduler
    (``_family_scheduler``: 4 slots, 8 requests, fault-free with --perf,
    the bound within 5% of ``_moe_round_bytes``, and under chaos); one
    batch of 4 with a ``MOE_PROMPT``-token prompt every way
    (``_serve_one_batch``: 5·L or 3·L / 1 / 2·L + 1 launches of kernels 1,
    2 and 6 a fused round, one kernel-4 launch a parity leaf), the batch's
    perf count, the graph round's breakdown, peak memory."""
    torch.cuda.reset_peak_memory_stats()
    model, params, init_s = _init_full_width(cfg)
    leaves = coded_gemms(cfg) // cfg.n_layers + 1
    sched = _family_scheduler(tag, cfg, model, params, MOE_ARGS, leaves,
                              _moe_round_bytes) if scheduler else None
    torch.cuda.empty_cache()
    one = _serve_one_batch(tag, cfg, model, params, MOE_PROMPT, leaves,
                           on_engine=_moe_on_engine)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    breakdown = _moe_breakdown(tag, one)
    layers = f", {cfg.n_layers} of 94 layers" if cfg.name.startswith(
        "qwen3") else ""
    _served_line(tag, cfg, one, f"a {MOE_PROMPT}-token prefill{layers}",
                 init_s, peak)
    return {**_summary(one), "peak_gib": peak, "init_s": init_s,
            "scheduler": sched, "batch_perf": one["on_engine"]["perf"],
            "breakdown": breakdown}


def serve_moe() -> dict:
    """Phase 16: the MoE family. Kernels 1, 2 and 4 at the two configs'
    widths against their plain versions (``check_width_kernels``; k 2048
    and 4096, the heads' m_l 37984) and kernels 1 and 2 timed there
    (``time_width_kernels``); then qwen2-moe-a2.7b at full width in
    ``QWEN2_LAYERS`` of its 24 layers (d 2048, 16 heads, 60 routed experts
    of 1408, top-4, 4 shared ones as one coded FFN of 5632, vocab 151936)
    through the scheduler and one batch (kernel 1 5 times a layer, kernel
    2 once, kernel 6 2L + 1 times a fused round), and qwen3-moe-235b-a22b
    at full width in 4 of its 94 layers (d 4096, 64 query heads of 128
    over 4 KV heads, 128 routed experts of 1536, top-8, no shared expert)
    through one batch (12 / 1 / 9 launches)."""
    t0 = time.perf_counter()
    cfgs = _moe_cfgs()
    err, timed = {}, {}
    for tag, (cfg, gemms) in cfgs.items():
        shapes = moe_shapes(cfg, gemms)
        err[tag] = dict(zip(("cdc_coded_matmul", "cdc_fused_head_argmax",
                             "cdc_encode"), check_width_kernels(tag, shapes)))
        timed[tag] = time_width_kernels(tag, shapes)
        torch.cuda.empty_cache()
    _phase_memory("MoE kernel checks and timings")
    out = {"qwen2": _serve_moe_model("qwen2", cfgs["qwen2"][0], True)}
    _phase_memory("serving qwen2-moe-a2.7b")
    out["qwen3"] = _serve_moe_model("qwen3", cfgs["qwen3"][0], False)
    secs = time.perf_counter() - t0
    log(f"phase 16 (qwen2-moe-a2.7b, qwen3-moe-235b-a22b in "
        f"{QWEN3_LAYERS} layers) took {secs:.1f} s")
    return {**out, "max_abs_err": err, "shapes": timed, "seconds": secs}


# ------------------------------------------------------------ phase 17 ----
# training: granite-3-8b at full width in TRAIN_LAYERS of its 40 layers,
# what launch.train --coded --tp 4 builds (float32, T = 4, r = 2 folded,
# remat "full"). A layer with its parity holds 264.2 M parameters, and the
# reference's AdamW keeps 20 bytes a parameter (params, grads, moments,
# float32 master): 40 layers would need ~221 GB, 4 with the embedding and
# the coded head ~31 GB
TRAIN_LAYERS = 4
TRAIN_STEPS = 6
TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_LR, TRAIN_WARMUP = 3e-3, 10
# One checkpoint of that state (params, moments, master copy; parity
# dropped) is 19.2 GB, and a machine with the card takes 45 GiB of disk
# writes a call: (b) saves none, (c)'s first Trainer one, at step 2
TRAIN_RESUME_AT = 2
NO_CKPT = 10 ** 9
TRAIN_PROFILED = 3             # the step (from 0) run under the profiler
BWD_TOL = 1e-5                 # kernel 6's backward: dx, rtol = atol
BWD_DGAMMA_RTOL = 1e-4         # dgamma: max |err| / max |dgamma|; the
#                                kernel sums the rows in another order


def check_rmsnorm_bwd() -> dict:
    """Kernel 6's backward against ``ref.rmsnorm_bwd_ref`` (eps 1e-5): rows
    1, 17, 1024 and 8192 at d 4096, d 4093 (the scalar instantiation),
    rows at a stride of d + 8 (vectors) and d + 1 (scalar); dx within
    rtol = atol = 1e-5, dgamma within 1e-4 of its largest entry; a second
    call bitwise equal; every instantiation the plan names launched; a bf16
    input refused with a ValueError naming the dtype; and the autograd
    Function (``rmsnorm`` on inputs that require grad) giving the plain
    gradient at the training step's [1024, 4096]."""
    from repro_torch.kernels import ref, rmsnorm
    gen = torch.Generator(device="cuda").manual_seed(31)
    rmsnorm.rmsnorm_bwd.variants.clear()
    cases = [(rows, K, 0) for rows in (1, 17, 1024, 8192)]
    cases += [(64, 4093, 0), (1024, 4093, 0), (1024, K, 8), (1024, K, 1)]
    want, worst_dx, worst_dg = set(), 0.0, 0.0
    for rows, d, pad in cases:
        g = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        base = 3.0 * torch.randn((rows, d + pad), generator=gen,
                                 device="cuda")
        x = base[:, :d]
        dy = torch.randn((rows, d), generator=gen, device="cuda")
        dx, dg = rmsnorm.rmsnorm_bwd(x, g, dy, eps=1e-5)
        dx2, dg2 = rmsnorm.rmsnorm_bwd(x, g, dy, eps=1e-5)
        pdx, pdg = ref.rmsnorm_bwd_ref(x, g, dy, 1e-5)
        torch.cuda.synchronize()
        what = f"rmsnorm_bwd [{rows}, {d}] pad {pad}"
        torch.testing.assert_close(dx, pdx, rtol=BWD_TOL, atol=BWD_TOL,
                                   msg=lambda m: f"{what} dx: {m}")
        rel = float((dg - pdg).abs().max() / pdg.abs().max())
        if rel > BWD_DGAMMA_RTOL:
            raise AssertionError(f"{what}: dgamma off by {rel:.3e} of its "
                                 f"largest entry")
        if not (torch.equal(dx, dx2) and torch.equal(dg, dg2)):
            raise AssertionError(f"{what}: two calls differ")
        worst_dx = max(worst_dx, float((dx - pdx).abs().max()))
        worst_dg = max(worst_dg, rel)
        want.add(rmsnorm.variant(rmsnorm.rmsnorm_bwd_plan(
            d, d + pad if rows > 1 else d)))
    seen = dict(rmsnorm.rmsnorm_bwd.variants)
    if set(seen) != want or "scalar" not in seen:
        raise AssertionError(f"rmsnorm_bwd instantiations launched {seen}; "
                             f"the plan names {sorted(want)}")
    xb = torch.randn((4, K), device="cuda").to(torch.bfloat16)
    try:
        rmsnorm.rmsnorm_bwd(xb, torch.ones(K, device="cuda"), xb)
    except ValueError as e:
        if "bfloat16" not in str(e):
            raise
    else:
        raise AssertionError("rmsnorm_bwd accepted a bf16 input")
    x = torch.randn((8, 128, K), generator=gen, device="cuda")
    g = 1.0 + 0.1 * torch.randn(K, generator=gen, device="cuda")
    dy = torch.randn((8, 128, K), generator=gen, device="cuda")
    xr, gr = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    fwd0 = rmsnorm.rmsnorm.launches
    y = rmsnorm.rmsnorm(xr, gr, eps=1e-5)
    y.backward(dy)
    pdx, pdg = ref.rmsnorm_bwd_ref(x, g, dy, 1e-5)
    torch.testing.assert_close(y.detach(), ref.rmsnorm_ref(x, g, 1e-5),
                               rtol=BWD_TOL, atol=BWD_TOL)
    torch.testing.assert_close(xr.grad, pdx, rtol=BWD_TOL, atol=BWD_TOL)
    rel = float((gr.grad - pdg).abs().max() / pdg.abs().max())
    if rel > BWD_DGAMMA_RTOL or rmsnorm.rmsnorm.launches != fwd0 + 1:
        raise AssertionError(f"the autograd Function: dgamma {rel:.3e}, "
                             f"{rmsnorm.rmsnorm.launches - fwd0} forward "
                             f"launches")
    log(f"kernel rmsnorm_bwd: {len(cases)} cases (rows 1-8192, d 4096 and "
        f"4093, strided rows) within rtol=atol={BWD_TOL} (dx, max abs err "
        f"{worst_dx:.3e}) and {BWD_DGAMMA_RTOL} of dgamma's largest entry "
        f"({worst_dg:.3e}); repeats bitwise equal; bf16 refused; launches "
        f"per instantiation {seen}; the autograd Function at [8, 128, "
        f"{K}] matches the plain gradient")
    return {"dx": worst_dx, "dgamma_rel": worst_dg}


def check_grad_refusals() -> list[str]:
    """Every kernel without a backward (1-5 and 7) raises a RuntimeError on
    a CUDA input that requires grad (its output would carry no history),
    before it builds or launches anything."""
    from repro_torch.kernels import cdc_decode, cdc_encode, cdc_matmul, matmul
    x = torch.ones((4, 8), device="cuda", requires_grad=True)
    w = torch.ones((8, 16), device="cuda")
    ok = (True,) * T
    calls = {
        "cdc_coded_matmul": lambda: cdc_matmul.cdc_coded_matmul(
            x, w, w, "folded", T, R, w, w, w, ok),
        "cdc_fused_head_argmax": lambda: cdc_decode.cdc_fused_head_argmax(
            x, w[None], w, ok, vocab=16),
        "cdc_encode": lambda: cdc_encode.cdc_encode(
            x.reshape(T, 2, 4), np.ones((R, T)), layout="dedicated"),
        "cdc_decode_merge": lambda: cdc_matmul.cdc_decode_merge(
            x[None], w, "folded", T, R, w, w, w, ok),
        "cdc_decode": lambda: cdc_decode.cdc_decode(
            x[None].expand(T, 4, 8), x[0], ok),
        "matmul": lambda: matmul.matmul(x, w)}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} took an input that requires grad")
    log(f"kernels without a backward refuse a requires-grad input: "
        f"{sorted(calls)}")
    return sorted(calls)


def time_rmsnorm_bwd(rows: int = TRAIN_BATCH * TRAIN_SEQ) -> dict:
    """Kernel 6's backward at the training step's [rows, 4096], by CUDA
    events (inputs cold), beside its plain version and its bound: x and dy
    read once, dx written once, gamma read and dgamma written once (the
    per-block partials are scratch); ~10 flops an element. The library
    call is ``aten._fused_rms_norm_backward`` (dx and dgamma in one call),
    given the rstd its forward ``aten._fused_rms_norm`` returns, taken once
    outside the timing; it is checked against the plain gradient first."""
    from repro_torch.kernels import ref, rmsnorm
    gen = torch.Generator(device="cuda").manual_seed(37)
    scratch = torch.empty(64 * 2 ** 20, device="cuda")   # 256 MB > L2
    g = 1.0 + 0.1 * torch.randn(K, generator=gen, device="cuda")
    x = torch.randn((rows, K), generator=gen, device="cuda")
    dy = torch.randn((rows, K), generator=gen, device="cuda")
    ms = _time(lambda: rmsnorm.rmsnorm_bwd(x, g, dy, eps=1e-5),
               scratch.zero_)
    plain = _time(lambda: ref.rmsnorm_bwd_ref(x, g, dy, 1e-5), scratch.zero_)
    aten = torch.ops.aten
    _, rstd = aten._fused_rms_norm(x, [K], g, 1e-5)

    def library():
        return aten._fused_rms_norm_backward(dy, x, [K], rstd, g,
                                             [True, True])
    ldx, ldg = library()
    pdx, pdg = ref.rmsnorm_bwd_ref(x, g, dy, 1e-5)
    torch.testing.assert_close(ldx, pdx, rtol=BWD_TOL, atol=BWD_TOL)
    torch.testing.assert_close(ldg, pdg, rtol=BWD_DGAMMA_RTOL,
                               atol=BWD_DGAMMA_RTOL * float(pdg.abs().max()))
    lib = _time(library, scratch.zero_)
    out: list[dict] = []
    _row(out, "rmsnorm_bwd", f"[{rows}, {K}]", ms, plain, lib,
         4.0 * (3 * rows * K + 2 * K), 10.0 * rows * K)
    us = _profile_us(lambda: rmsnorm.rmsnorm_bwd(x, g, dy, eps=1e-5),
                     "rmsnorm_bwd")
    out[-1].update(profiler_us=us,
                   rows_ptxas=_usage("rmsnorm_bwd_rowsILi4EE"),
                   cols_ptxas=_usage("rmsnorm_bwd_cols"))
    log(f"  rmsnorm_bwd: {us:.3f} us a call by the profiler (both passes; "
        f"bound {out[-1]['bound_ms'] * 1e3:.3f} us); rows pass "
        f"{out[-1]['rows_ptxas']}")
    return out[-1]


def _train_cfg():
    import dataclasses
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("granite-3-8b"),
                               n_layers=TRAIN_LAYERS)


def _trainer(cfg, ckpt_dir: str, ckpt_every: int, device: str = "cuda",
             steps: int = TRAIN_STEPS):
    """A Trainer as launch.train builds it for --coded --tp 4 (remat
    "full"; the schedule over TRAIN_STEPS), logging every step."""
    from repro_torch.data import DataConfig
    from repro_torch.models import TPCtx, build
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig, TrainConfig
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R))
    return Trainer(
        model, TrainerConfig(steps=steps, ckpt_dir=ckpt_dir,
                             ckpt_every=ckpt_every, log_every=1,
                             device=device),
        AdamWConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                    warmup_steps=TRAIN_WARMUP),
        TrainConfig(remat="full"),
        DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                   global_batch=TRAIN_BATCH))


def _zero_counts():
    from repro_torch.kernels import accounting
    for fn in accounting.WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, "variants"):
            fn.variants.clear()


def _counts() -> dict:
    from repro_torch.kernels import accounting
    return {name: fn.launches for name, fn in accounting.WRAPPERS.items()}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _StepRecorder:
    """Wraps a Trainer's ``step_fn``: per step the wall time to a
    synchronised end, the loss and global norm, and the launches of each
    kernel; step ``profiled`` runs under torch.profiler."""

    def __init__(self, step_fn, device, profiled: int | None = None):
        self.step_fn, self.device, self.profiled = step_fn, device, profiled
        self.steps: list[dict] = []
        self.prof = None

    def __call__(self, params, opt_state, batch):
        from torch.profiler import ProfilerActivity, profile
        before = _counts()
        _sync(self.device)
        t0 = time.perf_counter()
        if len(self.steps) == self.profiled:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = self.step_fn(params, opt_state, batch)
                _sync(self.device)
            self.prof = prof
        else:
            out = self.step_fn(params, opt_state, batch)
            _sync(self.device)
        secs = time.perf_counter() - t0
        m = out[2]
        after = _counts()
        self.steps.append({
            "s": secs, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
            "launches": {k: after[k] - before.get(k, 0) for k in after
                         if after[k] != before.get(k, 0)}})
        return out


def _train_split(prof) -> dict:
    """The profiled step's device time: the GEMMs (cuBLAS/CUTLASS kernels
    by name), kernel 6 forward and backward (by name), the optimizer and
    the loss (their record_function ranges in the train step; the loss's
    forward only, its backward runs on autograd's thread), and the rest;
    and by the step's ranges: the forward, the optimizer, and the
    backward as what is left."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0
            and not e.key.startswith("train.")]   # the ranges' own spans
    total = sum(ms for _, ms, _ in rows)
    if not total:
        log("profiler: no device time recorded; the step's split is not "
            "measured")
        return {}

    def named(*parts):
        return sum(ms for k, ms, _ in rows
                   if any(p in k.lower() for p in parts))

    def ranged(name):
        return sum(e.device_time_total for e in prof.events()
                   if e.name == name
                   and e.device_type == torch.autograd.DeviceType.CPU) / 1e3

    out = {"device_ms": total, "gemm": named("gemm", "gemv"),
           "kernel_6": named("rmsnorm_kernel"),
           "kernel_6_bwd": named("rmsnorm_bwd"),
           "optimizer": ranged("train.optimizer"),
           "loss": ranged("train.loss"), "forward": ranged("train.forward")}
    out["rest"] = total - sum(out[k] for k in ("gemm", "kernel_6",
                                               "kernel_6_bwd", "optimizer",
                                               "loss"))
    # the backward runs on autograd's thread, outside its range: the rest
    out["backward"] = total - out["forward"] - out["optimizer"]
    rows.sort(key=lambda r: -r[1])
    out["top"] = [{"kernel": k[:90], "ms": ms, "count": c}
                  for k, ms, c in rows[:12]]
    log(f"profiler, the training step: device busy {total:.3f} ms: GEMMs "
        f"{out['gemm']:.3f}, kernel 6 {out['kernel_6']:.3f} (backward "
        f"{out['kernel_6_bwd']:.3f}), optimizer {out['optimizer']:.3f}, "
        f"loss {out['loss']:.3f}, the rest {out['rest']:.3f}; by kernel:")
    for k, ms, c in rows[:12]:
        log(f"  {ms:8.3f} ms  x{c:<4d} {k[:90]}")
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _expect(name: str, got: int, want: int):
    if got != want:
        raise AssertionError(f"{name}: {got} launches, expected {want}")


@contextlib.contextmanager
def _kernel_free(what: str):
    """No kernel inside the block: the norms on their plain version with
    autograd (``transformer.rmsnorm`` patched, as phase 3 does for
    serving) and the parity encoded by kernel 4's plain version; raises
    if anything launched."""
    from repro_torch.kernels import cdc_encode, ops, ref
    from repro_torch.models import transformer
    encode, norm = ops.cdc_encode, transformer.rmsnorm
    ops.cdc_encode = cdc_encode.encode_plain
    transformer.rmsnorm = lambda p, x, eps: ref.rmsnorm_ref(x, p["g"], eps)
    before = _counts()
    try:
        yield
    finally:
        ops.cdc_encode, transformer.rmsnorm = encode, norm
    launched = {k: n - before[k] for k, n in _counts().items()
                if n != before[k]}
    if launched:
        raise AssertionError(f"{what} launched {launched}")


def _train_kernel_free(cfg, ckpt_dir: str, device) -> list[dict]:
    """A second Trainer of the same settings run with no kernel
    (``_kernel_free``): the same seed, loop and data stream. Its steps'
    records."""
    with _kernel_free("the kernel-free run"):
        tr = _trainer(cfg, ckpt_dir, NO_CKPT, device)
        rec = _StepRecorder(tr.step_fn, device)
        tr.step_fn = rec
        tr.run(resume=False)
    return rec.steps


def _through_a_failure(trainer, params) -> dict:
    """(d): with shard 2 dead, the loss within 1e-3 of the fault-free loss
    on the next batch, every gradient finite (the reference's
    test_train_through_failure, at full width). The trained params' parity
    is re-encoded first: AdamW moves each parity leaf on its own (zero
    gradient with no mask, weight decay), as the reference's does, so after
    a step it no longer encodes its weights until the offline encode runs
    again."""
    from repro_torch.data import make_stream
    from repro_torch.train import train_step
    from repro_torch.tree import named_leaves
    with torch.no_grad():
        params = trainer.model.encode_offline(params)
    loss_fn = train_step.make_loss_fn(trainer.model, trainer.scfg)
    batch = {k: torch.as_tensor(v, device=trainer.device) for k, v in
             next(make_stream(trainer.dcfg, TRAIN_STEPS)).items()}
    with torch.no_grad():
        ok = float(loss_fn(params, batch))
    dead = tuple(i != 2 for i in range(T))
    loss, grads = train_step.value_and_grad(loss_fn, params, batch, dead)
    bad = [n for n, g in named_leaves(grads)
           if g is not None and not bool(torch.isfinite(g).all())]
    if abs(ok - float(loss)) >= 1e-3 or bad:
        raise AssertionError(f"training through shard 2 dead: loss "
                             f"{float(loss)} vs {ok} fault-free; non-finite "
                             f"gradients {bad}")
    log(f"(d) through a failure: loss {float(loss):.6f} with shard 2 dead, "
        f"{ok:.6f} fault-free (|diff| {abs(ok - float(loss)):.3e}); every "
        f"gradient finite, the parity leaves' included")
    return {"loss_dead": float(loss), "loss_ok": ok}


def _launch_train(ckpt_dir: str, device) -> dict:
    """(e): the entry point in a subprocess (on the card unless ``device``
    is the CPU)."""
    import os
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "granite-3-8b", "--smoke", "--coded", "--steps", "20",
           "--no-resume", "--ckpt-dir", ckpt_dir]
    cmd += ["--device", "cpu"] if torch.device(device).type == "cpu" else []
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=ROOT, env={**os.environ,
                                        "PYTHONPATH": str(ROOT / "src")})
    secs = time.perf_counter() - t0
    lines = out.stdout.splitlines()
    rows = [ln.split(",") for ln in lines[lines.index("step,loss") + 1:]
            if "," in ln and not ln.startswith("#")] \
        if "step,loss" in lines else []
    if out.returncode != 0 or [int(s) for s, _ in rows] != [5, 10, 15, 20] \
            or not all(np.isfinite(float(v)) for _, v in rows) \
            or not any(ln.startswith("# wall:") for ln in lines):
        raise AssertionError(f"launch.train: rc {out.returncode}\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
    log(f"(e) python -m repro_torch.launch.train --smoke --coded --steps 20 "
        f"on {device}: rc 0 in {secs:.1f} s; " + " ".join(lines[-6:]))
    return {"seconds": secs, "losses": [(int(s), float(v)) for s, v in rows]}


def train_model(cfg, device="cuda") -> dict:
    """(b)-(e) of phase 17 on ``cfg`` (launch counts checked on the card).
    (b) 6 steps through the port's Trainer (lr 3e-3, warmup 10, batch 8 x
    128 of the synthetic stream, no checkpoint; ``n_params`` counts the
    parity): losses finite; per step 4L + 1 launches of kernel 6 (the 2L +
    1 norms of the forward, and the 2L of the layers the backward
    recomputes under remat "full") and 2L + 1 of its backward, none of
    kernels 1, 2 and 4; the parity encoded at init by kernel 4 twice (in
    Model.init's linear_init and by the offline encode, as the reference's
    init and Trainer do); the same steps kernel-free (run first, from the
    same seed, a second Trainer): every loss and grad_norm within 1e-4
    relative; step times, tokens/s, peak memory and the profiled step's
    split. (c) a Trainer of 2 steps with ckpt_every 2 (its async
    checkpoint at step 2), then one of 6 steps that resumes there (the
    parity re-encoded by kernel 4): steps 1-2 and 3-6 give (b)'s losses
    within 1e-5. (d) a loss and gradient with shard 2 dead. (e)
    launch.train in a subprocess."""
    import os
    import shutil
    import tempfile
    from repro_torch.tree import leaves
    card = torch.device(device).type == "cuda"
    L = cfg.n_layers
    coded = coded_gemms(cfg) // L + 1      # parity leaves: one launch each
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t_free = time.perf_counter()
        free = _train_kernel_free(cfg, os.path.join(root, "free"), device)
        log(f"(b) {cfg.name} in {L} layers, kernel-free: {TRAIN_STEPS} "
            f"steps in {time.perf_counter() - t_free:.1f} s with the init, "
            f"losses {[round(f['loss'], 5) for f in free]}")
        tr = _trainer(cfg, os.path.join(root, "b"), NO_CKPT, device)
        rec = _StepRecorder(tr.step_fn, device, TRAIN_PROFILED if card
                            else None)
        tr.step_fn = rec
        if card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t_run = time.perf_counter()
        run = tr.run(resume=False)
        run_s = time.perf_counter() - t_run
        counts = _counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if card else 0.0
        n_params = sum(t.numel() for t in leaves(run["params"]))
        del run
        steps = rec.steps
        losses = [s["loss"] for s in steps]
        if not all(np.isfinite(losses)) or len(steps) != TRAIN_STEPS:
            raise AssertionError(f"training losses {losses}")
        for i, s in enumerate(steps if card else ()):
            n = s["launches"]
            _expect(f"step {i + 1} kernel 6", n.get("rmsnorm", 0), 4 * L + 1)
            _expect(f"step {i + 1} kernel 6 backward",
                    n.get("rmsnorm_bwd", 0), 2 * L + 1)
            for k in ("cdc_coded_matmul", "cdc_fused_head_argmax",
                      "cdc_encode"):
                _expect(f"step {i + 1} {k}", n.get(k, 0), 0)
        if card:
            _expect("kernel 4 at init", counts["cdc_encode"], 2 * coded)
        timed = [s["s"] for i, s in enumerate(steps)
                 if i not in (0, TRAIN_PROFILED)]
        step_s = float(np.median(timed))
        split = _train_split(rec.prof) if rec.prof is not None else {}
        log(f"(b) {TRAIN_STEPS} steps through the Trainer in {run_s:.1f} s "
            f"(its init included): losses {[round(v, 5) for v in losses]}, "
            f"grad_norm {[round(s['grad_norm'], 5) for s in steps]}; "
            f"median step {step_s * 1e3:.1f} ms (steps 2-6 but the profiled "
            f"one; the first {steps[0]['s'] * 1e3:.1f} ms), "
            f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.0f} tokens/s; peak "
            f"{peak:.2f} GiB; launches a step {steps[-1]['launches']}, "
            f"kernel 4 {counts['cdc_encode']} at init")
        for i, (s, f) in enumerate(zip(steps, free)):
            if _rel(s["loss"], f["loss"]) > 1e-4 or \
                    _rel(s["grad_norm"], f["grad_norm"]) > 1e-4:
                raise AssertionError(
                    f"step {i + 1}: loss {s['loss']} / grad_norm "
                    f"{s['grad_norm']} vs kernel-free {f['loss']} / "
                    f"{f['grad_norm']}")
        worst = (max(_rel(s["loss"], f["loss"]) for s, f in zip(steps, free)),
                 max(_rel(s["grad_norm"], f["grad_norm"])
                     for s, f in zip(steps, free)))
        log(f"(b) against the kernel-free run: every step's loss within "
            f"{worst[0]:.3e} and grad_norm within {worst[1]:.3e} (relative)")
        if card:
            torch.cuda.empty_cache()

        dir_c = os.path.join(root, "c")
        first = _trainer(cfg, dir_c, TRAIN_RESUME_AT, device,
                         steps=TRAIN_RESUME_AT)
        t_ck = time.perf_counter()
        head = [loss for _, loss in first.run(resume=False)["losses"]]
        ck_s = time.perf_counter() - t_ck
        tr2 = _trainer(cfg, dir_c, NO_CKPT, device)
        rec2 = _StepRecorder(tr2.step_fn, device)
        tr2.step_fn = rec2
        resume, at_resume = tr2.maybe_resume, {}

        def counted_resume(*a):
            n0 = _counts()["cdc_encode"]
            got = resume(*a)
            at_resume["cdc_encode"] = _counts()["cdc_encode"] - n0
            at_resume["step"] = got[2]
            return got
        tr2.maybe_resume = counted_resume
        t_res = time.perf_counter()
        run2 = tr2.run(resume=True)
        res_s = time.perf_counter() - t_res
        if card:
            _expect("kernel 4 at resume", at_resume["cdc_encode"], coded)
        resumed = head + [s["loss"] for s in rec2.steps]
        if at_resume["step"] != TRAIN_RESUME_AT or \
                len(resumed) != TRAIN_STEPS or \
                any(_rel(a, b) > 1e-5 for a, b in zip(resumed, losses)):
            raise AssertionError(f"resumed losses {resumed} (from step "
                                 f"{at_resume['step']}) vs {losses}")
        log(f"(c) {TRAIN_RESUME_AT} steps and the async checkpoint in "
            f"{ck_s:.1f} s; resumed from step {TRAIN_RESUME_AT} in "
            f"{res_s:.1f} s (init, restore, re-encode: "
            f"{at_resume['cdc_encode']} kernel-4 launches, then 4 steps): "
            f"losses {[round(v, 6) for v in resumed]}, within "
            f"{max(_rel(a, b) for a, b in zip(resumed, losses)):.3e} of "
            f"(b)'s")
        failure = _through_a_failure(tr2, run2["params"])
        del run2
        if card:
            torch.cuda.empty_cache()
        entry = _launch_train(os.path.join(root, "e"), device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"steps": steps, "kernel_free": free, "step_ms": step_s * 1e3,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
            "peak_gib": peak, "split": split, "run_s": run_s,
            "n_params": n_params, "k4_init": counts["cdc_encode"],
            "k4_resume": at_resume["cdc_encode"],
            "k6": counts["rmsnorm"], "k6_bwd": counts["rmsnorm_bwd"],
            "resumed": resumed, "checkpoint_s": ck_s, "resume_s": res_s,
            "failure": failure, "launch_train": entry}


def train_granite() -> dict:
    """Phase 17: training. (a) kernel 6's backward against its plain
    version, timed; the kernels without a backward refuse a requires-grad
    input. Then (b)-(e) (``train_model``) on granite-3-8b at full width in
    TRAIN_LAYERS of its 40 layers."""
    t0 = time.perf_counter()
    out = {"max_abs_err": check_rmsnorm_bwd(),
           "refused": check_grad_refusals(), "timed": time_rmsnorm_bwd()}
    _phase_memory("rmsnorm_bwd checks and timing")
    out.update(train_model(_train_cfg()))
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 17 (training granite-3-8b, {TRAIN_LAYERS} of 40 layers) "
        f"took {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------ phase 18 ----
# distribution across real processes: a world of ranks, one process a rank,
# all on the one card. NCCL refuses two ranks of one communicator on one
# GPU, so the ranks talk over gloo, which stages every CUDA tensor through
# pinned host buffers (dist.comm): the times below are host-staged gloo on
# one card, no yardstick for a collective. The GEMMs and decodes run on the
# card.
DIST_ROWS = (4, 64)
DIST_REPS = 3                  # timed calls a (case, mask) after the check
DIST_WORLD_S = 300.0           # a world's deadline
DIST_T12_GEMMS = ("wq", "w1")
DIST_SEED = 31
MOE_SEED = 33
PIPE_LAYERS, PIPE_STAGES, PIPE_MB = 8, 4, 4
PIPE_BATCH, PIPE_SEQ = 8, 128
ELASTIC_DIR = ROOT / "build" / "smoke" / "elastic_ckpt"


def _dist_masks(t: int, layout: str) -> list[tuple]:
    """The all-valid mask, every single dead rank, and (dedicated, r = 2)
    ranks 1 and 2 dead together."""
    masks = list(_masks(t))
    if layout == "dedicated":
        masks.append(tuple(i not in (1, 2) for i in range(t)))
    return masks


def _rank_peak() -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30


def dist_gemm_cases(rank: int, mesh, t: int, gemms, layouts,
                    rows_list=DIST_ROWS, reps: int = DIST_REPS) -> dict:
    """(a) / (b) on one rank: ``coded_matmul_shardmap`` at granite's widths
    for code width t (r = 2) under every mask of ``_dist_masks``. Every
    rank generates the same x, w and parity (one seeded generator on the
    card; the parity by kernel 4) and reads only its own blocks. Each call
    must be within 1e-4 of the single-process ``core.coded_matmul`` on the
    card (kernel 1) and 2e-3 of x @ w, finite (the dead rank sent NaN), and
    launch kernel 3 once under <= 1 dead (none beyond). Then ``reps``
    calls are timed to a synchronised end (ms a call, wall clock)."""
    import torch.distributed as dist
    from repro_torch.core.coded_layer import coded_matmul
    from repro_torch.dist import coded_matmul_shardmap, comm
    from repro_torch.kernels import cdc_matmul
    gen = torch.Generator(device="cuda").manual_seed(DIST_SEED + t)
    widths = granite_widths(t)
    k3 = cdc_matmul.cdc_decode_merge.launches
    out, worst, worst_exact, calls, calls_le1 = [], 0.0, 0.0, 0, 0
    for g in gemms:
        for layout in layouts:
            for rows in rows_list:
                spec, x, w, wc = _coded_case(widths[g], rows, layout, gen,
                                             t=t)
                exact = x @ w
                ms, moved = [], None
                for valid in _dist_masks(t, layout):
                    v = np.array(valid)
                    n_dead = int((~v).sum())
                    want = coded_matmul(x, w, wc, spec, v, use_fused=True)
                    before = cdc_matmul.cdc_decode_merge.launches
                    comm.reset()
                    got = coded_matmul_shardmap(x, w, wc, spec, v,
                                                mesh=mesh)
                    torch.cuda.synchronize()
                    moved = moved or dict(comm.COUNTS)
                    launched = cdc_matmul.cdc_decode_merge.launches - before
                    if launched != (1 if n_dead <= 1 else 0):
                        raise AssertionError(
                            f"rank {rank} {g} {layout} rows {rows} mask "
                            f"{valid}: kernel 3 launched {launched} times")
                    if not torch.isfinite(got).all():
                        raise AssertionError(
                            f"rank {rank} {g} {layout} mask {valid}: a dead "
                            f"rank's NaN reached the output")
                    torch.testing.assert_close(got, want, rtol=1e-4,
                                               atol=1e-4)
                    torch.testing.assert_close(got, exact, rtol=2e-3,
                                               atol=2e-3)
                    worst = max(worst, float((got - want).abs().max()))
                    worst_exact = max(worst_exact,
                                      float((got - exact).abs().max()))
                    calls += 1
                    if n_dead <= 1:
                        calls_le1 += 1 + reps
                        dist.barrier()
                        for _ in range(reps):
                            t0 = time.perf_counter()
                            coded_matmul_shardmap(x, w, wc, spec, v,
                                                  mesh=mesh)
                            torch.cuda.synchronize()
                            ms.append((time.perf_counter() - t0) * 1e3)
                        calls += reps
                out.append({"gemm": g, "layout": layout, "rows": rows,
                            "m_l": widths[g], "ms": float(np.median(ms)),
                            "bytes_a_call": moved["sent"] + moved["received"],
                            "staged_a_call": moved["staged"]})
                del x, w, wc, exact, want, got
    k3 = cdc_matmul.cdc_decode_merge.launches - k3
    if k3 != calls_le1:
        raise AssertionError(f"rank {rank}: kernel 3 launched {k3} times in "
                             f"{calls_le1} calls with <= 1 dead")
    return {"cases": out, "max_abs_err": worst,
            "max_abs_err_exact": worst_exact, "k3": k3, "calls": calls}


def _moe_layer(cfg, device="cuda"):
    """One qwen2-moe layer at full width from MOE_SEED: the router, the
    routed experts and the coded shared experts (T = 4, parity by kernel
    4), float32."""
    from repro_torch.models import TPCtx, ffn
    gen = torch.Generator(device=device).manual_seed(MOE_SEED)
    return ffn.moe_init(gen, cfg, TPCtx(tp=T, mode="coded", code_r=R),
                        torch.float32, device=device)


def dist_moe(rank: int, mesh) -> dict:
    """(c) on one rank: qwen2-moe's MoE layer expert-parallel over (model
    4), 15 of the 60 experts on this rank, tokens replicated, capacity
    1.25: ``ffn.moe`` (branching to ``_moe_sharded``: one all-reduce) on
    4 decode tokens and a 4 x 128 prefill, within 1e-5 of the
    single-process ``_moe_local`` on the card. Returns the rank's layer
    blocks too (for (e))."""
    from repro_torch.configs import get_arch
    from repro_torch.dist import comm, param_specs, shard_params
    from repro_torch.models import TPCtx, ffn
    from repro_torch.tree import tree_map
    cfg = get_arch("qwen2-moe-a2.7b")
    full = _moe_layer(cfg)
    e = full["router"]["w"].shape[-1]
    specs = param_specs(full, mesh, fsdp=None)
    blocks = tree_map(torch.clone, shard_params(full, mesh, rank,
                                                specs=specs))
    routed = {k: blocks[k] for k in ("router", "we1", "we2", "we3")}
    ctx = TPCtx(tp=T, moe_capacity=1.25, mesh=mesh)
    ctx0 = TPCtx(tp=T, moe_capacity=1.25)
    gen = torch.Generator(device="cuda").manual_seed(MOE_SEED + 1)
    out = {"expert_bytes": sum(routed[k].numel() * routed[k].element_size()
                               for k in ("we1", "we2", "we3")),
           "experts": int(routed["we1"].shape[0])}
    worst = 0.0
    for tag, s in (("decode", 1), ("prefill", 128)):
        x = torch.randn((4, s, cfg.d_model), generator=gen, device="cuda")
        want = ffn._moe_local(ctx0, full, x.reshape(-1, cfg.d_model), e,
                              cfg.top_k).reshape(x.shape)
        comm.reset()
        got = ffn.moe(ctx, routed, cfg, x)
        torch.cuda.synchronize()
        moved = dict(comm.COUNTS)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        worst = max(worst, float((got - want).abs().max()))
        ms = []
        for _ in range(DIST_REPS):
            t0 = time.perf_counter()
            ffn.moe(ctx, routed, cfg, x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[tag] = {"tokens": int(x.shape[0] * s), "ms": float(np.median(ms)),
                    "bytes_a_call": moved["sent"] + moved["received"],
                    "all_reduces": moved["calls"]}
    out["max_abs_err"] = worst
    del full
    torch.cuda.empty_cache()
    return out, blocks, specs


def _pipe_cfg():
    import dataclasses
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("granite-3-8b"),
                               n_layers=PIPE_LAYERS)


def dist_pipeline(rank: int) -> dict:
    """(d) on one rank: ``pipeline_apply`` over (pod 4): granite-3-8b's
    full-width layer (``transformer._layer_fwd``, plain, its norms on
    kernel 6), 2 of the 8 layers a stage, batch 8 x 128 in 4
    microbatches, timed on its second call. Rank 0 also runs the 8 layers
    in order on the whole batch (one process) and holds the pipeline's
    result within 1e-4."""
    from repro_torch.dist import Mesh, comm, pipeline_apply
    from repro_torch.kernels import rmsnorm
    from repro_torch.models import TPCtx, transformer
    from repro_torch.tree import tree_map
    cfg = _pipe_cfg()
    ctx = TPCtx(tp=T)
    gen = torch.Generator(device="cuda").manual_seed(DIST_SEED)
    layers = transformer.init_params(cfg, gen, ctx, torch.float32,
                                     "cuda")["layers"]
    torch.cuda.empty_cache()
    x = torch.randn((PIPE_BATCH, PIPE_SEQ, cfg.d_model), generator=gen,
                    device="cuda")

    def layer(p, h):
        return transformer._layer_fwd(cfg, ctx, p, h, None, None, None, 0,
                                      512, 1024)

    mesh = Mesh((PIPE_STAGES,), ("pod",))
    pipeline_apply(layer, layers, x, mesh=mesh, n_microbatches=PIPE_MB)
    torch.cuda.synchronize()           # warm: groups, cuBLAS, buffers
    before = rmsnorm.rmsnorm.launches
    comm.reset()
    t0 = time.perf_counter()
    y = pipeline_apply(layer, layers, x, mesh=mesh,
                       n_microbatches=PIPE_MB)
    torch.cuda.synchronize()
    out = {"ms": (time.perf_counter() - t0) * 1e3,
           "k6": rmsnorm.rmsnorm.launches - before,
           "bytes": comm.COUNTS["sent"] + comm.COUNTS["received"]}
    if out["k6"] != 2 * (PIPE_LAYERS // PIPE_STAGES) * PIPE_MB:
        raise AssertionError(f"rank {rank}: kernel 6 launched {out['k6']} "
                             f"times in its stage")
    if not torch.isfinite(y).all():
        raise AssertionError("the pipeline's output is not finite")
    if rank == 0:
        h = x
        t0 = time.perf_counter()
        for i in range(PIPE_LAYERS):
            h = layer(tree_map(lambda a: a[i], layers), h)
        torch.cuda.synchronize()
        out["sequential_ms"] = (time.perf_counter() - t0) * 1e3
        torch.testing.assert_close(y, h, rtol=1e-4, atol=1e-4)
        out["max_abs_err"] = float((y - h).abs().max())
    del layers
    torch.cuda.empty_cache()
    return out


def dist_world4(rank: int, n: int) -> dict:
    """World A of phase 18 (4 ranks on the card): (a), (c), (d), and (e)'s
    save of (c)'s layer from the world."""
    from repro_torch.ckpt import save
    from repro_torch.device import set_true_f32
    from repro_torch.dist import Mesh
    set_true_f32()
    mesh = Mesh((n,), ("model",))
    out = {"a": dist_gemm_cases(rank, mesh, n, ("wq", "wk", "w1"),
                                ("folded", "dedicated"))}
    out["a"]["peak_gib"] = _rank_peak()
    torch.cuda.reset_peak_memory_stats()
    out["c"], blocks, specs = dist_moe(rank, mesh)
    out["c"]["peak_gib"] = _rank_peak()
    t0 = time.perf_counter()
    save(blocks, str(ELASTIC_DIR), 1, mesh=mesh, specs=specs)
    out["e_save_s"] = time.perf_counter() - t0
    del blocks
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["d"] = dist_pipeline(rank)
    out["d"]["peak_gib"] = _rank_peak()
    out["launches"] = _counts()
    return out


def dist_world12(rank: int, n: int) -> dict:
    """World B of phase 18 (12 ranks on the card): (b), the paper's 12
    devices, folded r = 2."""
    from repro_torch.device import set_true_f32
    from repro_torch.dist import Mesh
    set_true_f32()
    out = dist_gemm_cases(rank, Mesh((n,), ("model",)), n, DIST_T12_GEMMS,
                          ("folded",))
    out["peak_gib"] = _rank_peak()
    out["launches"] = _counts()
    return out


def _layer_equal(got, want, where: str) -> int:
    from repro_torch.tree import named_leaves
    n = 0
    for (name, a), (_, b) in zip(named_leaves(got), named_leaves(want)):
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{where}: leaf {name} differs after the "
                                 f"elastic restore")
        n += 1
    return n


def dist_restore2(rank: int, n: int) -> dict:
    """(e) on a rank of a 2-rank world: restore the checkpoint saved from
    the 4-rank world onto (model 2), each rank reading its own block (30
    experts), the shared experts' parity re-encoded by kernel 4; every
    leaf equal to the bit to this rank's block of the layer regenerated
    from its seed."""
    from repro_torch.ckpt import restore
    from repro_torch.configs import get_arch
    from repro_torch.dist import Mesh, local_shard, param_specs
    from repro_torch.models import TPCtx
    from repro_torch.tree import tree_map
    mesh = Mesh((n,), ("model",))
    full = _moe_layer(get_arch("qwen2-moe-a2.7b"))
    specs = param_specs(full, mesh, fsdp=None)
    t0 = time.perf_counter()
    got = restore(full, str(ELASTIC_DIR), 1, device="cuda", mesh=mesh,
                  shardings=specs,
                  encode_ctx=TPCtx(tp=T, mode="coded", code_r=R))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want = tree_map(lambda a, s: local_shard(a, s, mesh, rank), full, specs)
    return {"leaves": _layer_equal(got, want, f"rank {rank} of 2"),
            "restore_s": secs, "launches": _counts(),
            "experts": int(got["we1"].shape[0]), "peak_gib": _rank_peak()}


def serve_distributed() -> dict:
    """Phase 18: the distribution layer across real processes on the one
    card (worlds over gloo; kernels built by phase 1, loaded by the
    ranks). (a) the coded GEMM at T = 4 (wq, wk, w1; 4 and 64 rows; both
    layouts; every single dead rank and a 2-dead dedicated mask), (c) the
    expert-parallel MoE, (d) GPipe over 4 stages, (e) the save of (c)'s
    layer from 4 ranks and its restore onto 2 ranks and onto one process;
    (b) the coded GEMM at T = 12 over 12 ranks."""
    import shutil
    from repro_torch.ckpt import restore
    from repro_torch.configs import get_arch
    from repro_torch.dist import spawn_world
    from repro_torch.models import TPCtx
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    card = card_line()
    world_s = {}
    for name, fn, n in (("world4", dist_world4, T),
                        ("world12", dist_world12, T12),
                        ("world2", dist_restore2, 2)):
        t1 = time.perf_counter()
        world_s[name] = (spawn_world(fn, n, timeout_s=DIST_WORLD_S),
                         time.perf_counter() - t1)
        log(f"  {name}: {world_s[name][1]:.1f} s from spawn to results")
    (w4, _), (w12, _), (w2, _) = world_s.values()
    # (e) onto one process: this one
    full = _moe_layer(get_arch("qwen2-moe-a2.7b"))
    t1 = time.perf_counter()
    got = restore(full, str(ELASTIC_DIR), 1, device="cuda",
                  encode_ctx=TPCtx(tp=T, mode="coded", code_r=R))
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t1
    n_one = _layer_equal(got, full, "one process")
    del full, got
    ck_bytes = sum(p.stat().st_size for p in ELASTIC_DIR.rglob("*.npy"))
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    torch.cuda.empty_cache()

    out = {"card": card, "backend": "gloo (host-staged, one card)",
           "world_s": {k: v[1] for k, v in world_s.items()}}
    for tag, world, t in (("a", [r["a"] for r in w4], T), ("b", w12, T12)):
        masks_le1 = [r["k3"] for r in world]
        out[tag] = {"ranks": t, "k3_per_rank": masks_le1,
                    "calls_per_rank": world[0]["calls"],
                    "max_abs_err": max(r["max_abs_err"] for r in world),
                    "max_abs_err_exact": max(r["max_abs_err_exact"]
                                             for r in world),
                    "peak_gib_per_rank": [r["peak_gib"] for r in world],
                    "cases": world[0]["cases"],
                    "ms_per_rank": [[c["ms"] for c in r["cases"]]
                                    for r in world]}
        for i, c in enumerate(world[0]["cases"]):
            ms = [r["cases"][i]["ms"] for r in world]
            log(f"  ({tag}) T = {t} {c['gemm']} (m_l {c['m_l']}) "
                f"{c['layout']} rows {c['rows']}: {c['ms']:.3f} ms a call on "
                f"rank 0 (ranks {min(ms):.3f}-{max(ms):.3f}), "
                f"{c['bytes_a_call']} bytes a rank a call, "
                f"{c['staged_a_call']} staged; gloo on {card}")
        log(f"  ({tag}) kernel 3 launches per rank {masks_le1} over "
            f"{world[0]['calls']} calls each (one a call with <= 1 dead), "
            f"max abs err {out[tag]['max_abs_err']:.3e} vs the "
            f"single-process coded GEMM (kernel 1), "
            f"{out[tag]['max_abs_err_exact']:.3e} vs x @ w; peak GiB per "
            f"rank {[round(g, 2) for g in out[tag]['peak_gib_per_rank']]}")
    out["c"] = [r["c"] for r in w4]
    for rank, c in enumerate(out["c"]):
        log(f"  (c) rank {rank}: {c['experts']} experts, {c['expert_bytes']} "
            f"expert bytes; decode {c['decode']['ms']:.3f} ms, prefill "
            f"{c['prefill']['ms']:.3f} ms a call, "
            f"{c['prefill']['bytes_a_call']} bytes a prefill call "
            f"({c['prefill']['all_reduces']} all-reduce); max abs err "
            f"{c['max_abs_err']:.3e} vs _moe_local; peak "
            f"{c['peak_gib']:.2f} GiB")
    out["d"] = [r["d"] for r in w4]
    d0 = out["d"][0]
    log(f"  (d) pipeline over {PIPE_STAGES} stages x "
        f"{PIPE_LAYERS // PIPE_STAGES} granite layers, batch {PIPE_BATCH} x "
        f"{PIPE_SEQ} in {PIPE_MB} microbatches: "
        f"{[round(d['ms'], 1) for d in out['d']]} ms per rank "
        f"(the 8 layers in order in one process {d0['sequential_ms']:.1f} "
        f"ms), max abs err {d0['max_abs_err']:.3e}; kernel 6 "
        f"{[d['k6'] for d in out['d']]} launches per stage; bytes per rank "
        f"{[d['bytes'] for d in out['d']]}; peak GiB per rank "
        f"{[round(d['peak_gib'], 2) for d in out['d']]}")
    out["e"] = {"save_s": [r["e_save_s"] for r in w4],
                "checkpoint_bytes": ck_bytes,
                "restore2": w2, "one_process_leaves": n_one,
                "one_process_restore_s": one_s}
    log(f"  (e) saved from 4 ranks ({ck_bytes} bytes, "
        f"{out['e']['save_s'][0]:.2f} s), restored onto 2 ranks "
        f"({[r['experts'] for r in w2]} experts, {w2[0]['leaves']} leaves "
        f"bitwise, {[round(r['restore_s'], 2) for r in w2]} s) and onto one "
        f"process ({n_one} leaves bitwise, {one_s:.2f} s)")
    out["launches"] = {"world4": [r["launches"] for r in w4],
                       "world12": [r["launches"] for r in w12],
                       "world2": [r["launches"] for r in w2]}
    for name, per_rank in out["launches"].items():
        log(f"  launches per rank of {name} (every call of the rank, the "
            f"oracles' too): " + ", ".join(
                f"{k} {[c[k] for c in per_rank]}" for k in per_rank[0]
                if any(c[k] for c in per_rank)))
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 18 (distribution: worlds of 4, 12 and 2 ranks on one card) "
        f"took {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------ phase 19 ----
# training the other families, and on a mesh. (a)-(d) run the train step
# (make_train_step: what the Trainer runs) at full width, float32, coded at
# T = 4, r = 2 folded, remat "full"; depth cut so that the AdamW state (20
# bytes a parameter) fits one card: qwen2-moe 2 of 24 layers (~1.95 B
# parameters with the parity, ~39 GB), hymba 4 of 32 (~0.35 B), xlstm all
# 12 blocks (~0.27 B), whisper 4 + 4 of 24 + 24 (~0.29 B). (e) trains
# granite-3-8b in 1 of its 40 layers (767.5 M parameters with the parity)
# through Trainer(mesh=) over a world of 4 ranks on the one card
FAMILY_RUNS = {            # tag: (arch, config fields replaced, batch, seq)
    "a": ("qwen2-moe-a2.7b", {"n_layers": 2}, 8, 128),
    "b": ("hymba-1.5b", {"n_layers": 4}, 8, 128),
    "c": ("xlstm-125m", {}, 8, 128),
    "d": ("whisper-medium", {"n_layers": 4, "encoder_layers": 4}, 4, 128),
}
FAMILY_STEPS = 3           # timed steps after the first, checked one
FAMILY_FREE_TOL = 1e-4     # step 1 against the kernel-free step (relative)
FAMILY_DEAD_TOL = 1e-3     # (a): the loss with shard 2 dead
MESH_SHAPE = (2, 2)        # (data, model)
MESH_LAYERS, MESH_STEPS = 1, 3
MESH_WORLD_S = 300.0


def _family_cfg(tag: str):
    from repro_torch.configs import get_arch
    name, over, _, _ = FAMILY_RUNS[tag]
    return dataclasses.replace(get_arch(name), **over)


def _family_batches(cfg, tag: str, n: int) -> list[dict]:
    """n steps of the synthetic token stream on the card (the Trainer's
    batches); whisper adds float32 numpy frames [batch, 1500, 1024] drawn
    from a seed, which ``Model._frames`` takes to the card."""
    from repro_torch.data import DataConfig, make_stream
    _, _, b, s = FAMILY_RUNS[tag]
    stream = make_stream(DataConfig(vocab=cfg.vocab, seq_len=s,
                                    global_batch=b))
    rng = np.random.default_rng(41)
    out = []
    for _ in range(n):
        batch = {"tokens": torch.as_tensor(next(stream)["tokens"],
                                           device="cuda")}
        if cfg.is_encdec:
            batch["frames"] = rng.normal(
                size=(b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        out.append(batch)
    return out


def _family_state(model):
    """Seeded params on the card, their parity encoded offline (kernel 4,
    or its plain version when patched), and a fresh AdamW state."""
    from repro_torch.optim import init_state
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    with torch.no_grad():
        params = model.encode_offline(params)
    return params, init_state(params)


def _family_step(model):
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, make_train_step
    return make_train_step(model, AdamWConfig(
        lr=TRAIN_LR, total_steps=1 + FAMILY_STEPS + 1,
        warmup_steps=TRAIN_WARMUP), TrainConfig(remat="full"))


def _family_kernel_free(model, batch) -> dict:
    """The first step with no kernel (``_kernel_free``, as phase 17's
    kernel-free Trainer), from the same seed."""
    with _kernel_free("the kernel-free step"):
        params, state = _family_state(model)
        rec = _StepRecorder(_family_step(model), "cuda")
        rec(params, state, batch)
    return rec.steps[0]


def _dead_loss(model, params, batch) -> dict:
    """(a): the loss on the init params with shard 2 dead against the
    fault-free loss (no gradient), and the largest logit difference (the
    recovery really ran: the two losses, means over 1024 tokens, can
    round alike)."""
    from repro_torch.train import lm_loss
    dead = tuple(i != 2 for i in range(T))
    with torch.no_grad():
        ok = model.forward(params, batch)
        lost = model.forward(params, batch, dead)
        out = {"loss_ok": float(lm_loss(ok, batch["tokens"],
                                        model.cfg.vocab)),
               "loss_dead": float(lm_loss(lost, batch["tokens"],
                                          model.cfg.vocab)),
               "max_logit_diff": float((ok - lost).abs().max())}
    out["diff"] = abs(out["loss_ok"] - out["loss_dead"])
    if out["diff"] >= FAMILY_DEAD_TOL or not np.isfinite(out["loss_dead"]):
        raise AssertionError(f"shard 2 dead: {out}")
    return out


def train_family(tag: str) -> dict:
    """One of (a)-(d): the kernel-free first step; then from the same seed
    the first step (loss and grad_norm within 1e-4 of it), FAMILY_STEPS
    timed steps and one profiled step; per step 2 * n - 1 launches of
    kernel 6 (n = norms a pass, the layers' ones again under remat) and n
    of its backward, none of kernels 1, 2 and 4; kernel 4 once for each
    parity leaf in Model.init and once more in the offline encode."""
    from repro_torch.models import TPCtx, build
    from repro_torch.tree import leaves, named_leaves
    cfg = _family_cfg(tag)
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R))
    _, _, b, s = FAMILY_RUNS[tag]
    n_steps = 1 + FAMILY_STEPS + 1
    batches = _family_batches(cfg, tag, n_steps)
    t0 = time.perf_counter()
    free = _family_kernel_free(model, batches[0])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    params, state = _family_state(model)
    k4_init = _counts()["cdc_encode"]
    n_cdc = sum(1 for n, _ in named_leaves(params) if n.endswith("/cdc"))
    n_params = sum(t.numel() for t in leaves(params))
    _expect(f"({tag}) kernel 4 at init", k4_init, 2 * n_cdc)
    dead = _dead_loss(model, params, batches[0]) if tag == "a" else None
    rec = _StepRecorder(_family_step(model), "cuda", profiled=n_steps - 1)
    for batch in batches:
        params, state, _ = rec(params, state, batch)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, state
    torch.cuda.empty_cache()
    first = rec.steps[0]
    err = {k: _rel(first[k], free[k]) for k in ("loss", "grad_norm")}
    if max(err.values()) > FAMILY_FREE_TOL or \
            not all(np.isfinite(st["loss"]) for st in rec.steps):
        raise AssertionError(f"({tag}) step 1 {first} vs kernel-free {free}")
    npp = norms_per_pass(cfg)
    fwd6 = 2 * npp - 1 if npp else 0
    for i, st in enumerate(rec.steps):
        n = st["launches"]
        _expect(f"({tag}) step {i + 1} kernel 6", n.get("rmsnorm", 0), fwd6)
        _expect(f"({tag}) step {i + 1} kernel 6 backward",
                n.get("rmsnorm_bwd", 0), npp)
        for k in ("cdc_coded_matmul", "cdc_fused_head_argmax", "cdc_encode"):
            _expect(f"({tag}) step {i + 1} {k}", n.get(k, 0), 0)
    step_s = float(np.median([st["s"] for st in rec.steps[1:-1]]))
    split = _train_split(rec.prof)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": b, "seq": s,
           "n_params": n_params, "kernel_free": free, "steps": rec.steps,
           "max_rel_err": err, "step_ms": step_s * 1e3,
           "tokens_per_s": b * s / step_s, "peak_gib": peak,
           "k4_init": k4_init, "k6": fwd6, "k6_bwd": npp, "split": split,
           "dead": dead, "seconds": time.perf_counter() - t0}
    log(f"({tag}) {cfg.name} ({cfg.n_layers} layers"
        + (f" + {cfg.encoder_layers} encoder" if cfg.is_encdec else "")
        + f", {n_params / 1e9:.3f} B parameters with the parity), batch "
        f"{b} x {s}: step 1 loss {first['loss']:.6f}, grad_norm "
        f"{first['grad_norm']:.5f}, within {err['loss']:.3e} / "
        f"{err['grad_norm']:.3e} of the kernel-free step; losses "
        f"{[round(st['loss'], 5) for st in rec.steps]}; median step "
        f"{step_s * 1e3:.1f} ms ({FAMILY_STEPS} timed), "
        f"{b * s / step_s:.0f} tokens/s, peak {peak:.2f} GiB; kernel 6 "
        f"{fwd6} + {npp} (backward) a step, kernel 4 {k4_init} at init"
        + (f"; shard 2 dead: loss {dead['loss_dead']:.6f} vs "
           f"{dead['loss_ok']:.6f} (|diff| {dead['diff']:.3e}, logits "
           f"within {dead['max_logit_diff']:.3e})"
           if dead else "")
        + (f"; device ms: forward {split['forward']:.3f}, backward "
           f"{split['backward']:.3f}, optimizer {split['optimizer']:.3f} "
           f"of {split['device_ms']:.3f}" if split else "")
        + f"; {out['seconds']:.1f} s")
    return out


def _mesh_cfg():
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("granite-3-8b"),
                               n_layers=MESH_LAYERS)


def _mesh_trainer(ckpt_dir: str, mesh=None):
    """(e)'s Trainer: granite in MESH_LAYERS layers as launch.train builds
    it for --coded --tp 4 (phase 17's settings), MESH_STEPS steps, no
    checkpoint."""
    from repro_torch.data import DataConfig
    from repro_torch.models import TPCtx, build
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig, TrainConfig
    cfg = _mesh_cfg()
    return Trainer(
        build(cfg, TPCtx(tp=T, mode="coded", code_r=R)),
        TrainerConfig(steps=MESH_STEPS, ckpt_dir=ckpt_dir,
                      ckpt_every=NO_CKPT, log_every=1, device="cuda"),
        AdamWConfig(lr=TRAIN_LR, total_steps=MESH_STEPS,
                    warmup_steps=TRAIN_WARMUP),
        TrainConfig(remat="full"),
        DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                   global_batch=TRAIN_BATCH), mesh=mesh)


class _MeshStepRecorder(_StepRecorder):
    """A rank's step recorder: also the step's ``comm`` counts."""

    def __call__(self, params, opt_state, batch):
        from repro_torch.dist import comm
        comm.reset()
        out = super().__call__(params, opt_state, batch)
        self.steps[-1]["comm"] = dict(comm.COUNTS)
        return out


def mesh_train_rank(rank: int, n: int, ckpt_dir: str) -> dict:
    """A rank of (e)'s world: Trainer(mesh=) on (data 2, model 2)."""
    from repro_torch.device import set_true_f32
    from repro_torch.dist import Mesh
    set_true_f32()
    tr = _mesh_trainer(ckpt_dir, Mesh(MESH_SHAPE, ("data", "model")))
    rec = _MeshStepRecorder(tr.step_fn, "cuda")
    tr.step_fn = rec
    t0 = time.perf_counter()
    tr.run(resume=False)
    return {"steps": rec.steps, "run_s": time.perf_counter() - t0,
            "peak_gib": _rank_peak()}


def _mesh_step_bytes() -> dict:
    """One fault-free step's ``comm.COUNTS`` on a rank, as the library
    reckons it from the leaves' sizes (``trainer.mesh_step_messages``): an
    all-gather over the 4 ranks for each sharded leaf (the rank's block
    out, the 3 others in; block and result staged), an all-reduce over the
    data line for each gradient the loss reads (not the parity leaves) and
    one for the loss (each staged out and back)."""
    from repro_torch.dist import Mesh, comm
    from repro_torch.models import TPCtx, build
    from repro_torch.train.trainer import mesh_step_messages
    mesh = Mesh(MESH_SHAPE, ("data", "model"))
    params = build(_mesh_cfg(), TPCtx(tp=T, mode="coded", code_r=R)).init(
        0, device="meta")
    return comm.counts_of(mesh_step_messages(
        params, mesh, read=lambda n: not n.endswith("/cdc")), staged=True)


def train_mesh() -> dict:
    """(e): the single-process Trainer on the card first (then freed), then
    Trainer(mesh=) in a world of 4 ranks on (data 2, model 2), gloo: every
    rank's losses and grad norms within 1e-4 of the single process's;
    kernel 6 4L + 1 and its backward 2L + 1 times a step on every rank;
    every step's message bytes on every rank as reckoned. Host-staged
    gloo on one card is no yardstick for the messages' times."""
    import tempfile
    import shutil
    from repro_torch.dist import spawn_world
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        tr = _mesh_trainer(root)
        rec = _StepRecorder(tr.step_fn, "cuda")
        tr.step_fn = rec
        tr.run(resume=False)
        single = rec.steps
        del tr, rec
        torch.cuda.empty_cache()
        single_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        ranks = spawn_world(mesh_train_rank, int(np.prod(MESH_SHAPE)),
                            timeout_s=MESH_WORLD_S, args=(root,))
        world_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want = _mesh_step_bytes()
    L = MESH_LAYERS
    worst = 0.0
    for r, got in enumerate(ranks):
        if len(got["steps"]) != MESH_STEPS:
            raise AssertionError(f"(e) rank {r}: {len(got['steps'])} steps")
        for i, (st, one) in enumerate(zip(got["steps"], single)):
            err = max(_rel(st[k], one[k]) for k in ("loss", "grad_norm"))
            worst = max(worst, err)
            if err > TOL["rtol"]:
                raise AssertionError(f"(e) rank {r} step {i + 1}: {st} vs "
                                     f"one process {one}")
            n = st["launches"]
            _expect(f"(e) rank {r} step {i + 1} kernel 6",
                    n.get("rmsnorm", 0), 4 * L + 1)
            _expect(f"(e) rank {r} step {i + 1} kernel 6 backward",
                    n.get("rmsnorm_bwd", 0), 2 * L + 1)
            if st["comm"] != want:
                raise AssertionError(f"(e) rank {r} step {i + 1}: comm "
                                     f"{st['comm']}, reckoned {want}")
    step_ms = [[round(st["s"] * 1e3, 1) for st in got["steps"]]
               for got in ranks]
    out = {"single": single, "ranks": ranks, "bytes_a_step": want,
           "max_rel_err": worst, "single_s": single_s, "world_s": world_s,
           "step_ms_per_rank": step_ms,
           "peak_gib_per_rank": [g["peak_gib"] for g in ranks]}
    log(f"(e) Trainer(mesh=) on (data {MESH_SHAPE[0]}, model "
        f"{MESH_SHAPE[1]}), granite-3-8b in {L} layer, {MESH_STEPS} steps "
        f"over gloo on one card: losses "
        f"{[round(st['loss'], 6) for st in ranks[0]['steps']]} and grad "
        f"norms within {worst:.3e} of the single process's "
        f"{[round(st['loss'], 6) for st in single]} on every rank; "
        f"kernel 6 {4 * L + 1} + {2 * L + 1} a step a rank; bytes a rank a "
        f"step as reckoned: {want}; ms a step per rank {step_ms}; peak GiB "
        f"per rank {[round(g, 2) for g in out['peak_gib_per_rank']]}; the "
        f"single process {single_s:.1f} s (ms a step "
        f"{[round(st['s'] * 1e3, 1) for st in single]}), the world "
        f"{world_s:.1f} s from spawn to results")
    return out


def train_families() -> dict:
    """Phase 19: (a)-(d) the train step of the other families, (e)
    Trainer(mesh=) over a world of ranks."""
    t0 = time.perf_counter()
    out = {}
    for tag in FAMILY_RUNS:
        out[tag] = train_family(tag)
        _phase_memory(f"training {out[tag]['arch']}")
    out["e"] = train_mesh()
    out["launches"] = {"rmsnorm": sum(
        out[t]["k6"] * len(out[t]["steps"]) for t in FAMILY_RUNS),
        "rmsnorm_bwd": sum(out[t]["k6_bwd"] * len(out[t]["steps"])
                           for t in FAMILY_RUNS),
        "cdc_encode": sum(out[t]["k4_init"] for t in FAMILY_RUNS)}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 19 (training qwen2-moe, hymba, xlstm, whisper; "
        f"Trainer(mesh=) over 4 ranks) took {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------ phase 20 ----

EXAMPLE_GEMM_TOL = 1e-5        # quickstart's recovered GEMM (CPU test's)
EXAMPLE_MODEL_TOL = 1e-4       # quickstart's logits under the dead shard
TRAIN_LM_STEPS = 3
SERVE_CDC_KERNELS = ("cdc_coded_matmul", "cdc_fused_head_argmax",
                     "cdc_encode", "rmsnorm")


def _to_cpu(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t,
                    tree)


def _signature(arguments: dict) -> tuple:
    """A kernel call's signature: each tensor's shape, dtype and strides,
    the host mask's bits, every other argument's repr."""
    def one(k, v):
        if k == "valid":
            v = v.cpu() if isinstance(v, torch.Tensor) else v
            return tuple(bool(b) for b in np.asarray(v).reshape(-1))
        if isinstance(v, torch.Tensor):
            return (tuple(v.shape), str(v.dtype), v.stride())
        if isinstance(v, np.ndarray):
            return (v.shape, v.tobytes())
        return repr(v)
    return tuple((k, one(k, v)) for k, v in arguments.items())


class _CallRecorder:
    """A cost sink (``accounting.counting``) that keeps a copy of the
    arguments of the first call of each kernel in ``names`` at each
    signature, outside graph captures (a capture runs nothing; the eager
    warm-up on clones before it is seen), so that the kernel and its
    plain version can be run again on the inputs the path gave it."""

    def __init__(self, names):
        self.names = set(names)
        self.calls: dict = {}          # (name, signature) -> arguments

    def inside_kernel(self):
        return contextlib.nullcontext()

    def kernel(self, name, arguments, result):
        capturing = torch.cuda.is_available() and \
            torch.cuda.is_current_stream_capturing()
        if name not in self.names or capturing:
            return
        key = (name, _signature(arguments))
        if key not in self.calls:
            self.calls[key] = {k: v.clone() if isinstance(v, torch.Tensor)
                               else v for k, v in arguments.items()}


def _plain_call(name: str, a: dict):
    """The plain version of kernel ``name`` on a recorded call's arguments."""
    from repro_torch.core.coding import host_mask
    from repro_torch.kernels import cdc_encode, cdc_matmul, ref
    if name == "cdc_coded_matmul":
        return cdc_matmul.coded_matmul_plain(**a)
    if name == "cdc_fused_head_argmax":
        return ref.fused_head_argmax_ref(
            a["x"], a["w_shards"], a["parity_w"],
            torch.as_tensor(host_mask(a["valid"])), a["vocab"])
    if name == "cdc_encode":
        return cdc_encode.encode_plain(a["w_shards"], a["gen"], a["layout"])
    return ref.rmsnorm_ref(a["x"], a["gamma"], a["eps"])


def _library_call(name: str, a: dict):
    """One torch call over the same inputs as kernel ``name``'s recorded
    call (the yardstick of its row): the GEMM over the shards and parity
    concatenated (kernels 1, 2; no decode, no norm, no argmax), the
    generator times the shards (4), ``F.rms_norm`` (6)."""
    import torch.nn.functional as F
    from repro_torch.core.coded_layer import unfold_parity
    from repro_torch.kernels.cdc_encode import host_generator
    if name == "cdc_coded_matmul":
        w, wc, t, r = a["w"], a["w_cdc"], a["T"], a["r"]
        k, m = w.shape
        par = unfold_parity(wc, t, r) if a["layout"] == "folded" else wc
        wcat = torch.cat([w, par.permute(1, 0, 2).reshape(k, r * (m // t))],
                         dim=1)
        return lambda: torch.matmul(a["x"], wcat)
    if name == "cdc_fused_head_argmax":
        ws = a["w_shards"]
        t, k, m_l = ws.shape
        wcat = torch.cat([ws.permute(1, 0, 2).reshape(k, t * m_l),
                          a["parity_w"]], dim=1)
        return lambda: torch.matmul(a["x"], wcat)
    if name == "cdc_encode":
        sh = a["w_shards"]
        gt = torch.as_tensor(host_generator(a["gen"]), device=sh.device,
                             dtype=sh.dtype)
        flat = sh.contiguous().reshape(sh.shape[:-2] + (-1,))
        return lambda: torch.matmul(gt, flat)
    x = a["x"]
    return lambda: F.rms_norm(x, (x.shape[-1],), a["gamma"], a["eps"])


def _pair_err(name: str, got, want) -> float:
    """Max abs error of a kernel's result against its plain version's,
    raising beyond the tolerance of its phase-2 check (kernel 2: equal
    tokens, the max logit within 1e-4; kernel 4 within 1e-5)."""
    if name == "cdc_fused_head_argmax":
        if not torch.equal(got[0].long(), want[0].long()):
            raise AssertionError(f"{name}: tokens {got[0].tolist()} != "
                                 f"plain {want[0].tolist()}")
        got, want = got[1], want[1]
    tol = dict(rtol=1e-5, atol=1e-5) if name == "cdc_encode" else TOL
    torch.testing.assert_close(got, want, **tol)
    return float((got - want).abs().max())


def _shape_of(a: dict) -> str:
    return " ".join(f"{k}{list(v.shape)}" for k, v in a.items()
                    if isinstance(v, torch.Tensor) and v.dim() >= 2)


def example_kernel_rows(rec: _CallRecorder, card: str) -> dict:
    """Each kernel of ``rec`` against its plain version on every input
    signature the example gave it (within the phase-2 tolerances), and
    at the largest of them (by the bytes ``ops.kernel_cost`` counts) its
    time, its plain version's, the library call's and its bound: {name:
    row}."""
    from repro_torch.kernels import accounting, ops
    scratch = torch.empty(64 * 2 ** 20, device="cuda")   # 256 MB > L2
    flush = scratch.zero_
    rows = {}
    for name in sorted(rec.names):
        calls = [a for (n, _), a in rec.calls.items() if n == name]
        if not calls:
            raise AssertionError(f"the example gave {name} no input outside "
                                 f"a graph capture")
        fn = accounting.WRAPPERS[name]
        worst, costs = 0.0, []
        with torch.no_grad():
            for a in calls:
                got = fn(**a)
                want = _plain_call(name, a)
                torch.cuda.synchronize()
                worst = max(worst, _pair_err(name, got, want))
                costs.append(ops.kernel_cost(name, a, got))
            i = max(range(len(calls)), key=lambda j: costs[j][1])
            a, (flops, nbytes) = calls[i], costs[i]
            ms = _time(lambda: fn(**a), flush)
            plain = _time(lambda: _plain_call(name, a), flush)
            lib = _time(_library_call(name, a), flush)
        dtype = next(v.dtype for v in a.values()
                     if isinstance(v, torch.Tensor) and v.is_floating_point())
        bound, by = _bound(nbytes, flops, BF16_FLOPS
                           if dtype == torch.bfloat16 else F32_FLOPS)
        rows[name] = {"shape": _shape_of(a), "signatures": len(calls),
                      "max_abs_err": worst, "ms": ms, "plain_ms": plain,
                      "library_ms": lib, "bound_ms": bound, "bound_by": by}
        log(f"{name} in serve_cdc: {len(calls)} input signatures within "
            f"tolerance of the plain version (max abs err {worst:.3e}); at "
            f"{rows[name]['shape']}: kernel {ms:.4f} ms, plain {plain:.4f} "
            f"ms, library {lib:.4f} ms, bound {bound:.4f} ms ({by}); {card}")
    return rows


def _run_example(name: str, mod, argv: list[str], device: str,
                 card: str) -> dict:
    """``mod.main(argv)`` with the kernel counts set to 0 just before and
    read just after: {"out", "seconds", "launches"}."""
    _zero_counts()
    _sync(device)
    t0 = time.perf_counter()
    out = mod.main(argv + ["--device", device])
    _sync(device)
    secs = time.perf_counter() - t0
    launches = {k: n for k, n in _counts().items() if n}
    log(f"example {name}: {secs:.2f} s, launches {launches} ({card})")
    return {"out": out, "seconds": secs, "launches": launches}


@contextlib.contextmanager
def _recorded_trainer(mod, device, recs: list):
    """``mod.Trainer`` for the block: each one built records its steps
    (``_StepRecorder``, its ``step_fn``) and is kept in ``recs``."""
    base = mod.Trainer

    class Recorded(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.step_fn = _StepRecorder(self.step_fn, device)
            recs.append(self)

    mod.Trainer = Recorded
    try:
        yield
    finally:
        mod.Trainer = base


def _history_gate(metrics: dict, card: str) -> dict:
    """Each example's metrics of the gate's table into a temporary
    history, then ``python -m repro_torch.obs.history check`` plain (exit
    0) and with ``--inject-slowdown 0.30`` (exit 1)."""
    from repro_torch.obs.history import append_snapshot
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "BENCH_history.jsonl")
        for name, m in metrics.items():
            append_snapshot(path, "examples", name, m, extra={"card": card})
        codes = {}
        for tag, extra in (("plain", []),
                           ("slowdown", ["--inject-slowdown", "0.30"])):
            res = subprocess.run(
                [sys.executable, "-m", "repro_torch.obs.history", "check",
                 "--path", path, *extra], capture_output=True, text=True,
                env=env, timeout=300)
            log(f"history check ({tag}): exit {res.returncode}\n"
                + res.stdout.rstrip())
            codes[tag] = res.returncode
    if codes != {"plain": 0, "slowdown": 1}:
        raise AssertionError(f"history gate exit codes {codes}, want plain "
                             f"0 and slowdown 1")
    return codes


def examples_and_history(device: str = "cuda") -> dict:
    """Phase 20: the four examples on the card, each held against the same
    work on the CPU (quickstart's GEMM and logits, multi_failure's
    recovered outputs, serve_cdc's tokens), kernels 1, 2, 4 and 6 against
    their plain versions on the inputs serve_cdc gave them, train_lm's
    steps, and the history gate over their throughputs."""
    from repro_torch.examples import (multi_failure, quickstart, serve_cdc,
                                      train_lm)
    from repro_torch.kernels import accounting
    t0 = time.perf_counter()
    card = card_line() if device == "cuda" else "cpu"
    runs = {}
    runs["quickstart"] = q = _run_example("quickstart", quickstart, [],
                                          device, card)
    a = _to_cpu(quickstart.inputs(device))
    valid = quickstart.dead_mask()
    y, _ = quickstart.coded_gemm(a["x"], a["w"], valid)
    ok, dead = quickstart.model_under_failure(a["model"], a["params"],
                                              {"tokens": a["tokens"]}, valid)
    o = q["out"]
    qs_gap = {"gemm": float((o["y"].cpu() - y).abs().max()),
              "logits_ok": float((o["logits_ok"].cpu() - ok).abs().max()),
              "logits_dead": float((o["logits_dead"].cpu() - dead)
                                   .abs().max())}
    if not (o["gemm_err"] <= EXAMPLE_GEMM_TOL
            and o["model_dev"] <= EXAMPLE_MODEL_TOL
            and qs_gap["gemm"] <= EXAMPLE_GEMM_TOL
            and max(qs_gap["logits_ok"], qs_gap["logits_dead"])
            <= EXAMPLE_MODEL_TOL):
        raise AssertionError(f"quickstart: errors {o['gemm_err']}, "
                             f"{o['model_dev']}; card against the CPU "
                             f"{qs_gap}")
    log(f"quickstart, card against the CPU on the same inputs: {qs_gap}")

    runs["multi_failure"] = m = _run_example("multi_failure", multi_failure,
                                             [], device, card)
    x, w = _to_cpu(multi_failure.inputs(device))
    mf_gap = {}
    for row in m["out"]:
        cpu = multi_failure.sweep_r(x, w, row["r"])
        gap = float((row["outputs"].cpu() - cpu["outputs"]).abs().max())
        mf_gap[row["r"]] = gap
        if abs(row["cond"] - cpu["cond"]) > 1e-6 * cpu["cond"] or \
                gap > multi_failure.AGREEMENT[row["r"]]:
            raise AssertionError(
                f"multi_failure r={row['r']}: cond {row['cond']} (CPU "
                f"{cpu['cond']}), outputs {gap} from the CPU's (limit "
                f"{multi_failure.AGREEMENT[row['r']]})")
    log(f"multi_failure: recovered outputs, card against the CPU, max abs "
        f"by r: {mf_gap} (limits {multi_failure.AGREEMENT})")

    rec = _CallRecorder(SERVE_CDC_KERNELS)
    with accounting.counting(rec):
        runs["serve_cdc"] = sc = _run_example("serve_cdc", serve_cdc, [],
                                              device, card)
    o = sc["out"]
    model = serve_cdc.make_model()
    work = serve_cdc.arrivals(model.cfg.vocab)
    _, cpu_tok = serve_cdc.serve(
        model, _to_cpu(serve_cdc.init_params(model, device)), work, [])
    if not (o["completed"] == o["requests"] == 6
            and o["tokens_ok"] == o["tokens_fail"] == cpu_tok):
        raise AssertionError(
            f"serve_cdc: {o['completed']}/{o['requests']} completed; "
            f"fault-free = with-failure {o['tokens_ok'] == o['tokens_fail']}"
            f", = the CPU's {o['tokens_ok'] == cpu_tok}")
    log("serve_cdc: 6/6 completed; the tokens fault-free, with shard 1 "
        "dead and of the CPU's fault-free run on the same params identical")
    kernel_rows = {}
    if device == "cuda":
        missing = [k for k in SERVE_CDC_KERNELS if not sc["launches"].get(k)]
        if missing:
            raise AssertionError(f"serve_cdc launched none of {missing}")
        kernel_rows = example_kernel_rows(rec, card)
    del rec

    recs = []
    with tempfile.TemporaryDirectory() as d, \
            _recorded_trainer(train_lm, device, recs):
        runs["train_lm"] = t = _run_example(
            "train_lm", train_lm,
            ["--steps", str(TRAIN_LM_STEPS), "--ckpt", os.path.join(d, "ck")],
            device, card)
    steps, dcfg = recs[0].step_fn.steps, recs[0].dcfg
    rows_x_seq = dcfg.global_batch * dcfg.seq_len
    if not (t["out"]["finite"] and len(steps) == TRAIN_LM_STEPS
            and [s for s, _ in t["out"]["losses"]] == [TRAIN_LM_STEPS]):
        raise AssertionError(f"train_lm: losses {t['out']['losses']}, "
                             f"{len(steps)} steps recorded")
    step_ms = [1e3 * st["s"] for st in steps]
    steady_ms = float(np.median(step_ms[1:]))
    log(f"train_lm: ms a step at {dcfg.global_batch} x {dcfg.seq_len} "
        f"{[round(s, 1) for s in step_ms]} "
        f"(the first with its warm-up), {steady_ms:.1f} after the first "
        f"({card})")

    n_tok = sum(len(v) for v in o["tokens_ok"].values()) + \
        sum(len(v) for v in o["tokens_fail"].values())
    gated = {"serve_cdc": {"tokens_per_s": n_tok / sc["seconds"]},
             "train_lm": {"tokens_per_s": rows_x_seq / (steady_ms / 1e3)}}
    codes = _history_gate(gated, card)
    secs = time.perf_counter() - t0
    log(f"phase 20 (the examples and the history gate) took {secs:.1f} s "
        f"({card})")
    return {"seconds": {k: r["seconds"] for k, r in runs.items()},
            "launches": {k: r["launches"] for k, r in runs.items()},
            "quickstart": {k: q["out"][k] for k in ("gemm_err", "model_dev")},
            "quickstart_card_vs_cpu": qs_gap,
            "multi_failure": [{k: v for k, v in row.items()
                               if k != "outputs"} for row in m["out"]],
            "multi_failure_card_vs_cpu": mf_gap,
            "serve_cdc": {k: v for k, v in o.items()
                          if k not in ("tokens_ok", "tokens_fail")},
            "kernel_rows": kernel_rows,
            "train_lm": {"losses": t["out"]["losses"], "step_ms": step_ms,
                         "steady_ms": steady_ms},
            "gated": gated, "history_exit": codes, "total_s": secs}


# --------------------------------------------------------------- main ----

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.device import set_true_f32
    from repro_torch.kernels import build
    set_true_f32()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    report = build.build_all()
    build_s = {"total": time.perf_counter() - t0,
               **{n: r["seconds"] for n, r in report.items()}}
    log(f"built {sorted(report)} in {build_s['total']:.1f} s (each source "
        f"done after: " + ", ".join(f"{n} {r['seconds']:.1f} s"
                                    for n, r in report.items()) + ")")
    spills = []
    for name, rep in report.items():
        entry = ""
        for line in rep["ptxas"].splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                use = line.split(":", 2)[-1].strip()
                if "spill" in line and \
                        "0 bytes spill stores, 0 bytes spill loads" not in use:
                    spills.append(f"{entry}: {use}")
                if "registers" in line:
                    PTXAS[entry] = use
                log(f"  {name} {entry}: {use}")
    if spills:
        raise AssertionError(f"ptxas spills: {spills}")

    cfg = get_arch("granite-3-8b")
    torch.cuda.reset_peak_memory_stats()
    with _phase(2, "kernel checks"):
        err4 = check_encode(cfg)
        err4_bf16, _ = check_encode_bf16(cfg)
        err1 = max(check_coded_matmul(), check_coded_matmul_r34(),
                   check_coded_matmul_t8(), check_coded_matmul_t16())
        err1_bf16 = check_coded_matmul_bf16()
        edge1, edge7 = check_stream_edges()
        cp1, cp1_bf16 = check_rowcopy()
        err2 = max(check_fused_head(cfg), check_head_edges())
        err2_bf16 = max(check_fused_head_wide(cfg),
                        check_head_edges(torch.bfloat16))
        err3 = check_decode_merge()
        err5 = check_decode()
        err6 = max(check_rmsnorm(), check_rmsnorm_edges())
        err7 = max(check_matmul(), edge7)
        err1 = max(err1, edge1)
        err1_bf16 = max(err1_bf16, cp1_bf16)
        # every other code width: the generic instantiations of kernels 1-5
        any_err = {"cdc_coded_matmul": check_coded_matmul_any(),
                   "cdc_fused_head_argmax": check_head_any(cfg)}
        any_err["cdc_decode_merge"], any_err["cdc_decode"] = \
            check_elementwise_any()
        any_err["cdc_encode"], err4_any_bf16 = check_encode_any()
        any_bf16 = {"cdc_coded_matmul":
                    check_coded_matmul_any(torch.bfloat16),
                    "cdc_fused_head_argmax":
                    check_head_any(cfg, torch.bfloat16),
                    "cdc_encode": err4_any_bf16}
        wcfg = get_arch(WHISPER)
        w_err = dict(zip(("cdc_coded_matmul", "cdc_fused_head_argmax",
                          "cdc_encode"), check_whisper_kernels(wcfg)))
        xcfg = get_arch(XLSTM)
        x_err = dict(zip(("cdc_coded_matmul", "cdc_fused_head_argmax",
                          "cdc_encode"), check_xlstm_kernels(xcfg)))
        hcfg = get_arch(HYMBA)
        h_err = dict(zip(("cdc_coded_matmul", "cdc_fused_head_argmax",
                          "cdc_encode"), check_hymba_kernels(hcfg)))
    _phase_memory("kernel checks")
    with _phase(3, "granite-3-8b served"):
        served = serve_full_width(cfg)
    torch.cuda.empty_cache()
    with _phase(4, "kernel timings"):
        timed = time_kernels(cfg)
        timed12 = time_t12(cfg)
        timed_cp = time_rowcopy()
        timed_w = time_whisper(wcfg)
        timed_x = time_xlstm(xcfg)
        timed_h = time_hymba(hcfg)
    torch.cuda.empty_cache()
    with _phase(5, "the scheduler"):
        sched = serve_scheduler(cfg)
    torch.cuda.empty_cache()
    with _phase(6, "the coded-cost study"):
        study = run_study()
    with _phase(7, "decode_and_merge's library entry"):
        entry = decode_merge_entry()
        entry12 = {"cdc_decode_merge": decode_merge_entry(T12),
                   "cdc_decode": decode_entry(T12)}
    _phase_memory("study and library entry")
    with _phase(8, "granite-3-8b at T = 16"):
        t16 = serve_t16(cfg)
    _phase_memory("serving at T = 16")
    with _phase(9, "granite-3-8b on bf16 weights"):
        bf16 = serve_bf16(cfg)
    _phase_memory("serving on bf16 weights")
    with _phase(10, "granite-3-8b at T = 12"):
        t12 = serve_t12(cfg)
    _phase_memory("serving at T = 12")
    with _phase(11, "h2o-danube-1.8b"):
        h2o = serve_h2o()
    _phase_memory("serving h2o-danube-1.8b")
    with _phase(12, "deepseek-67b, 12 layers"):
        deepseek = serve_deepseek()
    _phase_memory("serving deepseek-67b (12 layers)")
    with _phase(13, "whisper-medium"):
        whisper = serve_whisper()
    _phase_memory("serving whisper-medium")
    with _phase(14, "xlstm-125m"):
        xlstm = serve_xlstm()
    _phase_memory("serving xlstm-125m")
    hymba = serve_hymba()
    _phase_memory("serving hymba-1.5b")
    moe = serve_moe()
    _phase_memory("serving qwen3-moe-235b-a22b (4 layers)")
    training = train_granite()
    _phase_memory("training granite-3-8b (4 layers)")
    distributed = serve_distributed()
    _phase_memory("distribution (the parent's restore)")
    families = train_families()
    _phase_memory("training the other families and on a mesh")
    examples = examples_and_history()
    _phase_memory("the examples")
    w1 = timed[0]
    head = next(t for t in timed if t.get("gemm") == "lm_head")
    small = {(t["kernel"], t["shape"]): t for t in timed if "kernel" in t}
    enc = sched["timing"]["total"]

    def entry_of(name, src, replaces, launches, err, row):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{src}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}

    # launches: kernels 1, 2 and 6 from the fused serving run (phase 3),
    # kernel 4 from the chaos run (phase 5), kernels 5 and 7 from the
    # study (phase 6), kernel 3 from its library entry (phase 7)
    kernels = [
        entry_of("cdc_coded_matmul", "coded_matmul.cuh",
                 "src/repro/kernels/cdc_matmul.py:130", served["k1"], err1,
                 w1),
        entry_of("cdc_fused_head_argmax", "fused_head.cuh",
                 "src/repro/kernels/cdc_decode.py:138", served["k2"], err2,
                 head),
        entry_of("cdc_decode_merge", "cdc_decode_merge.cu",
                 "src/repro/kernels/cdc_matmul.py:208", entry["launches"],
                 err3, small[("cdc_decode_merge",
                              f"[{T}, 4, {GEMMS['w1']}] r={R} folded")]),
        entry_of("cdc_encode", "cdc_encode.cu",
                 "src/repro/kernels/cdc_encode.py:30",
                 sched["runs"]["chaos"]["launches"]["cdc_encode"], err4,
                 {**enc, "bound_by": "bytes"}),
        entry_of("cdc_decode", "cdc_decode.cu",
                 "src/repro/kernels/cdc_decode.py:56",
                 study["launches"]["cdc_decode"], err5,
                 small[("cdc_decode", "[8, 256, 512]")]),
        entry_of("rmsnorm", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:25",
                 served["k6"], err6, small[("rmsnorm", f"[4, {K}]")]),
        entry_of("matmul", "matmul.cu", "src/repro/kernels/matmul.py:31",
                 study["launches"]["matmul"], err7,
                 small[("matmul", "[512, 512] @ [512, 512]")]),
    ]
    # the generic instantiations at T = 12: kernels 1, 2 and 6's launches
    # from the T = 12 serving run (phase 10), kernel 4's from its engine's
    # encode, kernels 3 and 5's from their library entries at T = 12
    rows12 = {t.get("gemm", t.get("kernel")): t for t in timed12}
    enc12 = t12["encode"]["total"]
    kernels += [
        {**entry_of("cdc_coded_matmul", "coded_matmul.cuh",
                    "src/repro/kernels/cdc_matmul.py:130", t12["k1"],
                    max(any_err["cdc_coded_matmul"], cp1), rows12["w1"]),
         "name": "cdc_coded_matmul (T=12, w1)"},
        {**entry_of("cdc_fused_head_argmax", "fused_head.cuh",
                    "src/repro/kernels/cdc_decode.py:138", t12["k2"],
                    any_err["cdc_fused_head_argmax"], rows12["lm_head"]),
         "name": "cdc_fused_head_argmax (T=12)"},
        {**entry_of("cdc_decode_merge", "cdc_decode_merge.cu",
                    "src/repro/kernels/cdc_matmul.py:208",
                    entry12["cdc_decode_merge"]["launches"],
                    any_err["cdc_decode_merge"], rows12["cdc_decode_merge"]),
         "name": "cdc_decode_merge (T=12)"},
        {**entry_of("cdc_encode", "cdc_encode.cu",
                    "src/repro/kernels/cdc_encode.py:30", t12["k4"],
                    any_err["cdc_encode"], {**enc12, "bound_by": "bytes"}),
         "name": "cdc_encode (T=12, whole re-encode)"},
        {**entry_of("cdc_decode", "cdc_decode.cu",
                    "src/repro/kernels/cdc_decode.py:56",
                    entry12["cdc_decode"]["launches"],
                    any_err["cdc_decode"], rows12["cdc_decode"]),
         "name": "cdc_decode (T=12)"},
    ]
    # kernels 1 and 2 at whisper's widths: launches from its graph run
    # (phase 13)
    rows_w = {t["gemm"]: t for t in timed_w}
    kernels += [
        {**entry_of("cdc_coded_matmul", "coded_matmul.cuh",
                    "src/repro/kernels/cdc_matmul.py:130", whisper["k1"],
                    w_err["cdc_coded_matmul"], rows_w["whisper w1"]),
         "name": "cdc_coded_matmul (whisper, w1)"},
        {**entry_of("cdc_fused_head_argmax", "fused_head.cuh",
                    "src/repro/kernels/cdc_decode.py:138", whisper["k2"],
                    w_err["cdc_fused_head_argmax"],
                    rows_w["whisper lm_head"]),
         "name": "cdc_fused_head_argmax (whisper)"},
    ]
    # kernels 1 and 2 at xLSTM's widths: launches from its graph run
    # (phase 14)
    rows_x = {t["gemm"]: t for t in timed_x}
    kernels += [
        {**entry_of("cdc_coded_matmul", "coded_matmul.cuh",
                    "src/repro/kernels/cdc_matmul.py:130", xlstm["k1"],
                    x_err["cdc_coded_matmul"], rows_x["xlstm up"]),
         "name": "cdc_coded_matmul (xlstm, up)"},
        {**entry_of("cdc_coded_matmul", "coded_matmul.cuh",
                    "src/repro/kernels/cdc_matmul.py:130", xlstm["k1"],
                    x_err["cdc_coded_matmul"], rows_x["xlstm wq"]),
         "name": "cdc_coded_matmul (xlstm, wq)"},
        {**entry_of("cdc_fused_head_argmax", "fused_head.cuh",
                    "src/repro/kernels/cdc_decode.py:138", xlstm["k2"],
                    x_err["cdc_fused_head_argmax"], rows_x["xlstm lm_head"]),
         "name": "cdc_fused_head_argmax (xlstm)"},
    ]
    # kernels 1 and 2 at hymba's widths: launches from its graph run
    # (phase 15)
    rows_h = {t["gemm"]: t for t in timed_h}
    kernels += [
        {**entry_of("cdc_coded_matmul", "coded_matmul.cuh",
                    "src/repro/kernels/cdc_matmul.py:130", hymba["k1"],
                    h_err["cdc_coded_matmul"], rows_h[f"hymba {g}"]),
         "name": f"cdc_coded_matmul (hymba, {g})"}
        for g in ("wk", "in_proj", "w1")] + [
        {**entry_of("cdc_fused_head_argmax", "fused_head.cuh",
                    "src/repro/kernels/cdc_decode.py:138", hymba["k2"],
                    h_err["cdc_fused_head_argmax"], rows_h["hymba lm_head"]),
         "name": "cdc_fused_head_argmax (hymba)"}]
    # kernels 1 and 2 at the MoE's widths: launches from each model's graph
    # run (phase 16)
    for tag, gemms in (("qwen2", ("wq", "w1")), ("qwen3", ("wq", "wk"))):
        rows_m = {t["gemm"]: t for t in moe["shapes"][tag]}
        kernels += [
            {**entry_of("cdc_coded_matmul", "coded_matmul.cuh",
                        "src/repro/kernels/cdc_matmul.py:130",
                        moe[tag]["k1"],
                        moe["max_abs_err"][tag]["cdc_coded_matmul"],
                        rows_m[f"{tag} {g}"]),
             "name": f"cdc_coded_matmul ({tag}, {g})"} for g in gemms] + [
            {**entry_of("cdc_fused_head_argmax", "fused_head.cuh",
                        "src/repro/kernels/cdc_decode.py:138",
                        moe[tag]["k2"],
                        moe["max_abs_err"][tag]["cdc_fused_head_argmax"],
                        rows_m[f"{tag} lm_head"]),
             "name": f"cdc_fused_head_argmax ({tag})"}]
    # kernel 6's backward: launches from the Trainer's run (phase 17)
    kernels.append(entry_of(
        "rmsnorm_bwd", "rmsnorm_bwd.cu", "src/repro/models/common.py:155",
        training["k6_bwd"], training["max_abs_err"]["dx"],
        training["timed"]))
    # phase 19: kernel 6 and its backward in the family steps (a)-(d) and
    # kernel 4 at their inits; the times of phase 4's kernel-6 row and
    # phase 17's backward row
    kernels += [
        {**entry_of("rmsnorm", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:25",
                    families["launches"]["rmsnorm"], err6,
                    small[("rmsnorm", f"[4, {K}]")]),
         "name": "rmsnorm (training qwen2-moe, hymba, xlstm)"},
        {**entry_of("rmsnorm_bwd", "rmsnorm_bwd.cu",
                    "src/repro/models/common.py:155",
                    families["launches"]["rmsnorm_bwd"],
                    training["max_abs_err"]["dx"], training["timed"]),
         "name": "rmsnorm_bwd (training qwen2-moe, hymba, xlstm)"},
        {**entry_of("cdc_encode", "cdc_encode.cu",
                    "src/repro/kernels/cdc_encode.py:30",
                    families["launches"]["cdc_encode"], err4,
                    {**enc, "bound_by": "bytes"}),
         "name": "cdc_encode (the training families' inits)"},
    ]
    # kernel 3 on the distributed path: rank 0's launches in worlds A (T =
    # 4) and B (T = 12), its error against the single-process coded GEMM;
    # the times of the shapes those calls give it (phase 4)
    kernels += [
        {**entry_of("cdc_decode_merge", "cdc_decode_merge.cu",
                    "src/repro/kernels/cdc_matmul.py:208",
                    distributed[tag]["k3_per_rank"][0],
                    distributed[tag]["max_abs_err"], row),
         "name": f"cdc_decode_merge (distributed, T={t}, rank 0)"}
        for tag, t, row in (
            ("a", T, small[("cdc_decode_merge",
                            f"[{T}, 4, {GEMMS['w1']}] r={R} folded")]),
            ("b", T12, rows12["cdc_decode_merge"]))]
    # phase 20: kernels 1, 2, 4 and 6 in the serve_cdc example (smoke
    # h2o-danube-1.8b through the scheduler, fault-free and with shard 1
    # dead): its launches; the error over every input signature it gave
    # the kernel, the times and bound at the largest of them
    ex = examples["launches"]["serve_cdc"]
    ex_rows = examples["kernel_rows"]
    kernels += [
        {**entry_of(name, src, replaces, ex[name],
                    ex_rows[name]["max_abs_err"], ex_rows[name]),
         "name": f"{name} (serve_cdc example, {ex_rows[name]['shape']})"}
        for name, src, replaces in (
            ("cdc_coded_matmul", "coded_matmul.cuh",
             "src/repro/kernels/cdc_matmul.py:130"),
            ("cdc_fused_head_argmax", "fused_head.cuh",
             "src/repro/kernels/cdc_decode.py:138"),
            ("cdc_encode", "cdc_encode.cu",
             "src/repro/kernels/cdc_encode.py:30"),
            ("rmsnorm", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:25"))]
    log(card)
    runs = {n: {k: v for k, v in r.items() if k != "tokens"}
            for n, r in sched["runs"].items()}
    log(json.dumps({"shapes": timed, "round": served["breakdown"],
                    "graph_vs_eager": served["graph_vs_eager"],
                    "encode": sched["timing"], "scheduler": runs,
                    "study": study, "decode_merge_entry": entry,
                    "t16": t16, "bf16": bf16,
                    "bf16_max_abs_err": {"cdc_coded_matmul": err1_bf16,
                                         "cdc_fused_head_argmax": err2_bf16,
                                         "cdc_encode": err4_bf16},
                    "generic": {"max_abs_err": any_err,
                                "bf16_max_abs_err": any_bf16,
                                "t12_shapes": timed12,
                                "entries_t12": entry12},
                    "rowcopy": {"max_abs_err": cp1,
                                "bf16_max_abs_err": cp1_bf16,
                                "shapes": timed_cp},
                    "build": build_s, "t12": t12, "h2o": h2o,
                    "deepseek": deepseek,
                    "whisper": {**whisper, "shapes": timed_w,
                                "max_abs_err": w_err},
                    "xlstm": {**xlstm, "shapes": timed_x,
                              "max_abs_err": x_err},
                    "hymba": {**hymba, "shapes": timed_h,
                              "max_abs_err": h_err},
                    "moe": moe, "training": training,
                    "distributed": distributed, "families": families,
                    "examples": examples},
                   default=str))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
