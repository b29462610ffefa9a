#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (chromegcn_tpu_torch).

Run from the repository root on a machine with one CUDA card (built for an
H100, sm_90a):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``chromegcn_tpu_torch/csrc`` (one nvcc
per source, started together) and drives the port only (no JAX), one line
per phase:

1. the card (nvidia-smi name and power limit) and torch/CUDA versions;
2. the kernel builds, with nvcc's register/spill report, and the fused
   kernels' shared-memory plans against the Python ones that fused_fits
   reads;
3. kernel B1 (bsr_spmm, a row gather over each direction's edge form)
   against its plain PyTorch version on the card: the chr1-scale bench
   graph's forward and transposed directions at d 128 and 256, f32 and bf16,
   tile 256 with an integer threshold, an all-strips tiling, a hub graph
   (hubness 0.5, rows of up to ~170 entries), and small graphs against a
   dense float64 product, one of them with a row of 1,500 entries; widths
   that are not a multiple of 4 (d 1,850, 925, 6 and 1: the float2 and
   scalar paths), f32 and bf16, on the bench graph against the plain version
   and on a small graph against float64; and that each edge form holds
   exactly its blocks' nonzeros;
4. the SpmmBSR gradient against the plain version's autograd;
5. the unfused main path at bench.py's full width (N_PAD 50,176, d 128, 919
   classes, 2 layers, 2 strands, SGD lr 0.25): one kernel-path train step
   against one step of the plain COO path from the same weights, then
   5 train steps with dropout 0.2 and one eval step, counting kernel
   launches (8 B1 per train step, 4 per eval step; the loss's 2 BCE sum
   launches a step and 1 BCE gradient a train step); then the BCE kernels
   alone at bench and full chr1 size (249,856 x 919), the padded tail
   masked, against the plain formula (the sum in float64, the gradient's
   closed form under a cotangent other than 1), and their CUDA-event ms at
   full chr1 beside their bounds, the plain formula with autograd and the
   library's binary_cross_entropy_with_logits;
6. kernels B2 (gcn_fused) and B3 (gcn_fused_bwd), row gathers over the
   edge form with a 3xTF32 tensor-core epilogue, against their plain
   versions: the bench graph at d 128, f32 and bf16, the hub graph, d 192
   and a tile-256 operator; small graphs with an empty range of rows at
   d 32 for tile heights 32-256, and both kernels at the widest width the
   fused layer admits, against a dense float64 product;
7. the FusedGatedLayer gradients (dx, dw, db, du, dbu) against the plain
   version's autograd, at full width;
8. the fused main path at full width (``fused="on"``): one train step
   against one unfused kernel-path step from the same weights, then 5 train
   steps with dropout 0.2 and one eval step (4 B2 + 4 B3 per train step,
   4 B2 per eval step, no B1);
9. the finetune CLI (``chromegcn_tpu_torch.main``) with ``-gcn_fused on``,
   2 epochs on a synthetic world written with the port's savers (train: the
   bench chromosome; valid and test: one 10,000-window chromosome each):
   per-epoch losses, meanAUC, wall time and kernel launches;
10. timings after warm-up, the functions of a group timed in turns: B1, B2
   and B3 per launch, their plain versions and a library yardstick the port
   never calls (torch.sparse.mm over CSR, composed with the epilogue's ops
   for B2/B3), and B2's and B3's gather and epilogue apart. The headline is
   each call's device time from torch.profiler (every kernel the call runs,
   median (min-max) of 3 runs of 20); the CUDA-event loops (5 of 20), which
   include the host's launch gaps, are printed beside it as a record. Each
   kernel's share of its bound (what the data needs: the edge list, the
   dense arrays, 2 nnz d operations plus the epilogue GEMM at 3xTF32's rate)
   is taken from its device time. Then the train and eval steps, unfused and
   fused, on the host clock;
11. the window models (Expecto, DeepSEA, DanQ) at full width (seq 2,000,
   919 labels, d_model 128) on the card against the same weights on the
   CPU: a NonStrandSpecific eval forward of 8 sequences, and one train step
   on a batch of 4 with dropout 0: in float64 on the card against float64
   on the CPU (every gradient), and in f32 on the card against float64 (the
   loss, and every gradient but Expecto's below bn3, which pass back through
   train-mode BatchNorms over near-constant channels and land up to ~1e-1 of
   scale from float64 in f32 on any device); this holds the f32 parity mode
   (TF32 off; cuDNN off but for the LSTMs) faithful and the layouts right on
   the card;
12. the full-width pretrain step (Expecto at the CLI's defaults: batch 64,
   both strands, Adam lr 2e-4, dropout on) on the host clock, median
   (min-max) of 5 loops of 5 steps, windows/s, the eval step and the peak
   device memory; Expecto's step also with cuDNN on (TF32 off) and in the
   fast mode (cuDNN and TF32); DeepSEA and DanQ at the same shapes;
13. the three-mode pipeline through the CLI on a world of seq 2,000 and 919
   labels written with the port's savers (train chr2 and chr4, 2,048
   windows each; valid chr3 and test chr1, 1,024 each; Hi-C edges
   make_hic_edges(n, 5n)): Expecto -pretrain -epochs 2, -save_feats, then
   -load_pretrained -epochs 2 -gcn_fused on, warm-started (B2 and B3
   launches counted), -load_pretrained -chrome_model rnn -epochs 1, and
   -joint -epochs 1 -gcn_fused on warm-started from Expecto's stage 1 (B2
   and B3 launches counted), and -load_pretrained -spmm_form hybrid -epochs
   1 (B1 over both of the hybrid operator's parts, no B2 or B3); then DanQ
   -pretrain -epochs 1 and -save_feats (925 columns), whose finetune stops
   at the warm start as the reference's does;
14. ChromeRNN (-chrome_model rnn) on the bench chromosome as one sequence
   (N_PAD 50,176, d 128, hidden 64, 2 layers, 919 classes): the eval
   forward on the card against the CPU within 1e-4 of scale; one train step
   at N 4,096 in f32 and float64 on the card against float64 on the CPU;
   a traced train step that must run cuDNN's RNN forward and backward and
   no per-step cell kernel; the train and eval steps at bench scale on the
   host clock (median (min-max) of 3 after 1 warm-up) and the peak device
   memory; as a record, the step at N 4,096 with the LSTMs off cuDNN;
15. the joint step (Expecto at the CLI's defaults with the GCN, chunks of
   128 windows under checkpoint): on 256 windows, chunked against one
   unchunked pass and fused against unfused (loss rel 1e-5, both models'
   gradients within 1e-4 of scale); on 2,048 windows, unfused and fused,
   the train and eval steps on the host clock, windows/s, peak memory and
   launches per step (8 B1; 4 B2 + 4 B3; eval 4 B1 or 4 B2), and one step
   in the fast mode as a record;
16. the host ingest (``pipeline/``, ``native_bridge.py``) at full chr1:
   make_raw_world over hg19's chr1 (249,250,621 bp, 12 assays), its host
   seconds, file sizes and RAWobserved line count; the pipeline CLI
   (``python -m chromegcn_tpu_torch.pipeline --hicsize 500000 --hicnorm
   SQRTVC``) with build_dataset's and build_hic_graphs' host seconds apart and
   hic_topk's lines per second, its files held to the world's ground truth
   (kept windows, positive labels; symmetric edges among kept windows, equal
   to hic_topk's contacts); hic_topk_plain over the whole file and
   intersect_fraction_plain over each assay's first 25,000 windows against
   the native library; then on the card the ingested graph's flat operator,
   B1's A x and A^T g against the plain version, the full-width unfused train
   and eval steps with random features (8 and 4 B1 launches, host clock,
   peak memory) and B1's time against its bound beside the graph's longest
   row; last the chain raw files -> pipeline CLI -> Expecto -pretrain
   -epochs 1 -> -save_feats -> -load_pretrained -epochs 1 (unfused, its B1
   launches counted) on four ~4 Mbp chromosomes with 12 labels;
17. the full chr1-scale world (chr1 at 1 kb windows: make_hic_edges(249,088,
   500,000) as bench_hybrid.py builds it, 927,632 edges, N_PAD 249,856) at
   full width: the host build seconds of the flat, panelled (the reference's
   panel_bounds) and hybrid operator forms; B1 over the flat form, each
   panel and both of the hybrid's parts (the stragglers' edge form against
   index_select + index_add_) against their plain versions; the panelled
   and hybrid products, A x and A^T g, against the flat one; B2 and B3 over
   the flat form against their plain versions, and timed alone (CUDA
   events, and device time where a trace completes) against their bounds
   and library compositions; the unfused
   train step on the hybrid against the one on the flat form from the same
   weights (loss rel 1e-5, grads 1e-4 of scale); the unfused flat, unfused
   hybrid and fused flat train and eval steps on the host clock, with peak
   memory and launches (8 B1; 16 B1; 4 B2 + 4 B3); B1's device time over
   each form against the product's bound, and the card's cost model
   (ops/spmm_hybrid.py) fitted to B1's launches beside the one in the code,
   and what attach_auto('auto') picks at bench and full scale;
18. the analysis functions (analysis/saliency.py): feature_saliency,
   gate_values, refined_embeddings and adjacency_saliency on a 4,096-node
   graph on the card against the CPU in float64 (within 1e-4 of scale), and
   timed at bench scale with their B1 launches; tf_knockout_matrix over 3
   labels at bench scale; score_snp_table for 64 SNPs of a synthetic genome
   through Expecto, the card in f32 and float64 against the CPU in float64;
19. the parallel paths (``parallel/``) on phase 17's world, nothing cut:
   in-process (every shard on the card) at 2 and 4 shards, the host
   seconds of ``partition_graph`` and ``attach_shard_bsr``, each offset's
   halo width, each shard's local and halo nonzeros and the bytes one rank
   would send a product; every per-shard B1 launch (local and halo, both
   directions) against its plain version; the ``halo_bsr`` product A x and
   A^T g (autograd) against the flat one, with 2 B1 launches a shard a
   product (1 where its halo is empty); the unfused train step on the
   sharded graph against the flat one from the same weights (loss rel
   1e-5, grads 1e-4 of scale) and its launches; the sharded product
   against the flat one and each shard's B1 against its bound (CUDA
   events), and the sharded train and eval steps on the host clock with
   peak memory. Then one rank of an NCCL group: the distributed mode's
   step at 1 shard, its BatchNorm statistics, loss and gradients
   all-reduced on the card, against the plain step;
20. a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Phases 17, 18 and 19 run after 13 and before 14; phase 16 after 15. Every device time comes from
a complete torch.profiler trace (``traced``): in a long run on the H100 the
profiler has returned traces that lost some or all of the kernels that
ran, and such a trace is taken again. Any failed phase ends the run
with a non-zero exit code.

``python3 chip_smoke.py --profile`` adds to phases 10, 12, 14, 15 and 17 a
torch.profiler trace of train steps of each path (3 of the GCN's, at bench
and full scale, and Expecto's; one ChromeRNN step at bench scale and one
joint step at 256 windows):
device time per step by kernel or kernel group, and the device's idle share
of the step.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# bench.py's main path
N_VALID, N_PAD, N_PAIRS = 50_000, 50_176, 250_000
D, NCLASS, LAYERS, LR = 128, 919, 2, 0.25
TRAIN_STEPS = 5
# the finetune CLI's synthetic world: the bench chromosome to train on, one
# 10,000-window chromosome each to validate and test on
CLI_SPLITS = {"train": ("chr1", N_VALID, N_PAIRS, 0), "valid": ("chr2", 10_000, 50_000, 1),
              "test": ("chr3", 10_000, 50_000, 2)}
CLI_EPOCHS = 2
KERNELS = ("bsr_spmm", "gcn_fused", "gcn_fused_bwd", "bce_fused")
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# the fastest f32-faithful GEMM the port runs: 3xTF32 on tensor cores, three
# TF32 products (495 TFLOP/s dense, NVIDIA data sheet) per f32 one
TF32X3_FLOPS = 495e12 / 3
# kernel vs plain version: f32 sums of the same products in another order
ATOL, RTOL = 1e-5, 1e-5
# the window stage at the CLI's defaults (config.py): seq 2,000, batch 64,
# Adam lr 2e-4; the pipeline's world, per split {chrom: (windows, seed)}
SEQ_LEN, WINDOW_BATCH, WINDOW_LR = 2000, 64, 2e-4
WINDOW_MODELS = ("expecto", "deepsea", "danq")
PIPELINE_SPLITS = {"train": {"chr2": 2048, "chr4": 2048}, "valid": {"chr3": 1024},
                   "test": {"chr1": 1024}}
# profile groups of the window step, by words in the kernel's name
WINDOW_PROFILE_GROUPS = (
    ("BatchNorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "bn_")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "winograd", "implicit")),
    ("im2col/col2im", ("im2col", "col2im")),
    ("LSTM", ("lstm", "rnn", "persist")),
    ("GEMM", ("gemm", "cutlass", "cublas")),
    ("pooling", ("pool",)),
    ("reductions", ("reduce",)),
    ("optimizer", ("adam", "multi_tensor", "foreach")),
    ("elementwise", ("elementwise",)),
)
# ChromeRNN (phase 14): the train step held to float64 and the cuDNN-off
# record at this N; the kernel-route check traces a step at RNN_TRACE_N
RNN_CHECK_N, RNN_TRACE_N = 4096, 1024
# the joint step (phase 15): chunks of 128 windows, the GCN's Adam at the
# CLI's -lr2; correctness on JOINT_CHECK_N windows, timings on JOINT_N
JOINT_CHUNK, JOINT_N, JOINT_CHECK_N, JOINT_LR2 = 128, 2048, 256, 2e-3
# the full chr1-scale world (phase 17): chr1 at 1 kb windows and the
# reference's -hicsize 500000, as bench_hybrid.py:133-137 builds it
# (make_hic_edges with seed 107, hubness 0.6, compartment_frac 0.15), padded
# to the 2,048-node bucket
FULL_VALID, FULL_PAD, FULL_PAIRS = 249_088, 249_856, 500_000
FULL_EDGES = dict(seed=107, hubness=0.6, compartment_frac=0.15)
# what the reference's TPU run of that world recorded (HYBRID_r05.json): a
# record beside this run's counts, not a check (the generators may differ)
FULL_TPU_RECORD = "927,632 edges / 176,760 straggler edges / 1,946 dense tiles"
# the ingest (phase 16): hg19's chr1 (249,250,621 bp) written by make_raw_world
# (its 12 default assays, pairs_per_node 6) from this seed, through the
# pipeline at the reference's -hicsize 500000 and SQRTVC norm; the plain
# intersection is checked on each assay's first INGEST_INTERSECT_WINDOWS
# windows. The CLI chain's world: four ~4 Mbp chromosomes (chr1 test, chr3
# valid, chr2 and chr4 train), 12 labels (make_raw_world plants one motif per
# assay in a window, so it cannot give 919)
INGEST_SEED, INGEST_HICSIZE, INGEST_INTERSECT_WINDOWS = 16, 500_000, 25_000
INGEST_CHAIN_SIZES = {"chr1": 4_000_000, "chr2": 4_000_000, "chr3": 4_000_000,
                      "chr4": 4_000_000}
# the analysis phase (18): its float64 check at this N, and the SNPs it scores
ANALYSIS_N, SNPS = 4096, 64
# profile groups of the ChromeRNN step, by words in the kernel's name
RNN_PROFILE_GROUPS = (
    ("cuDNN RNN", ("rnn", "lstm", "persist", "elemwise")),
    ("GEMM", ("gemm", "cutlass", "cublas", "gemv")),
    ("BatchNorm, loss and head (elementwise, reductions)", ("elementwise", "reduce")),
)
# profile groups, by words in the kernel's name (first match wins)
PROFILE_GROUPS = (
    ("B1 bsr_spmm", ("bsr_spmm",)),
    ("B2/B3 gcn_fused", ("gcn_fused",)),
    ("GEMM", ("gemm",)),
    ("gather/scatter", ("index", "scatter", "gather")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def gcn_launches():
    """The GCN kernels' launches (B1, B2, B3) in ``_build.LAUNCHES``: every
    loss on the card also launches the BCE kernels (``bce_sum``,
    ``bce_sum_bwd``), which phase 5 counts and checks."""
    from chromegcn_tpu_torch.ops import _build

    return {k: v for k, v in _build.LAUNCHES.items()
            if k in ("bsr_spmm", "gcn_fused_fwd", "gcn_fused_bwd")}


def log(*parts):
    print(*parts, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fns, iters=20, repeats=5, warmup=3):
    """{name: sorted ms per call} for each function of ``fns``, CUDA events
    around ``iters`` calls, the functions timed in turns ``repeats`` times."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(repeats):
        for name, fn in fns.items():
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / iters)
    return {name: sorted(t) for name, t in times.items()}


def traced(fn, calls, what="a call", alike=True, attempts=5):
    """[(kernel, device us, count)] of every device event torch.profiler
    records over ``calls`` calls of ``fn``, from a complete trace: one that
    holds a device event, in which the port's kernels come as often as their
    wrappers counted launches (``_build.LAUNCHES``), and, where the calls
    are ``alike`` (one function of fixed inputs, not a train step, whose
    allocations and optimizer kernels vary from step to step), each kernel
    a multiple of ``calls`` times. Another trace is taken, up to
    ``attempts`` in all, and None returned if none was complete: on the
    H100, in a long run, torch.profiler has returned traces without some of
    the kernels that ran, or without any."""
    from chromegcn_tpu_torch.ops import _build

    for attempt in range(attempts):
        # hand the allocator's cached blocks back first: the profiler's own
        # buffers need device memory, which earlier phases may hold
        torch.cuda.empty_cache()
        before = dict(_build.LAUNCHES)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = []
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total", None)
            us = evt.self_cuda_time_total if us is None else us
            if us > 0:
                rows.append((evt.key, us, evt.count))
        ours = all(
            sum(c for key, _, c in rows if f"{kernel}_kernel" in key)
            == _build.LAUNCHES[launcher] - before.get(launcher, 0)
            for launcher, kernel in (("bsr_spmm", "bsr_spmm"), ("gcn_fused_fwd", "gcn_fused"),
                                     ("gcn_fused_bwd", "gcn_fused_bwd")))
        if rows and ours and (not alike or all(count % calls == 0 for _, _, count in rows)):
            return rows
        log(f"  torch.profiler lost device events of {what} (trace {attempt + 1} of {attempts})")
    return None


def device_ms(fn, iters=20, name="a call"):
    """Device time (ms) per call of ``fn``: every kernel, copy and fill the
    call runs on the card, summed from a complete torch.profiler trace
    (``traced``) of ``iters`` calls after warm-up. It leaves out the host's
    launch gaps, which the CUDA-event loops of ``cuda_ms`` include when the
    host is slow, and it counts a library call's several kernels
    (cuSPARSE's, a composition's) the way it counts one kernel of the port."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    rows = traced(fn, iters, name)
    require(rows is not None, f"torch.profiler lost device events of {name} in every trace")
    return sum(us for _, us, _ in rows) / iters / 1e3


def device_times(fns, iters=20, repeats=3):
    """{name: sorted device ms per call} for each function of ``fns``
    (``device_ms`` over ``iters`` calls), the functions profiled in turns
    ``repeats`` times."""
    times = {name: [] for name in fns}
    for _ in range(repeats):
        for name, fn in fns.items():
            times[name].append(device_ms(fn, iters, name))
    return {name: sorted(t) for name, t in times.items()}


def step_ms(fn, steps=3, warmup=1):
    """Sorted host-clock ms of ``steps`` synchronized calls of ``fn`` after
    ``warmup``, for steps that take seconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)


def spread(times):
    """'median (min-max)' of a sorted list of ms."""
    return f"{statistics.median(times):.4f} ({times[0]:.4f}-{times[-1]:.4f})"


def host_ms(fns, iters=5, repeats=5, warmup=2):
    """{name: sorted host-clock ms per call} for each function of ``fns``,
    ``repeats`` synchronized loops of ``iters`` calls, the functions timed
    in turns."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(repeats):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3 / iters)
    return {name: sorted(t) for name, t in times.items()}


def poison_allocator(shape):
    """Leave NaNs in the block the caching allocator hands out next, so rows a
    kernel fails to write show up as a mismatch."""
    t = torch.full(shape, float("nan"), device="cuda")
    del t


def compare(name, got, ref, scaled=False, scale=None):
    """max |got - ref|, required within allclose(rtol, atol); ``scaled``
    sets atol to ATOL times the reference's largest magnitude instead, and
    ``scale`` to ATOL times that scale."""
    err = (got - ref).abs().max().item()
    if scale is None:
        scale = ref.abs().max().item()
        atol = ATOL * scale if scaled else ATOL
    else:
        atol = ATOL * scale
    tol = atol + RTOL * scale
    ok = bool(torch.isfinite(got).all()) and torch.allclose(got, ref, rtol=RTOL, atol=atol)
    log(f"  {name}: max_abs_err {err:.3e} (allclose rtol {RTOL} atol {atol:.3e}; "
        f"max tol {tol:.3e}) {'ok' if ok else 'MISMATCH'}")
    require(ok, f"{name} disagrees with its reference")
    return err


def bound(m, d):
    """Least time (ms) for one out = A @ x, whatever implements it: the
    larger of the bytes the data needs (each nonzero's value and 4-byte
    column, the n_rows + 1 row pointers, x read once, out written once)
    over HBM bandwidth, and its operations (one multiply-add per nonzero and
    column of x) over the peak rate of the values' type. The nonzeros are
    those of ``m``'s live blocks, which its edge form holds. Returns (ms,
    'bytes' or 'operations', bytes, operations)."""
    nnz = m.nnz
    nbytes = (nnz * (m.val.element_size() + 4) + 4 * (m.n_rows + 1)
              + 4 * d * (m.n_rows + m.n_cols))
    flops = 2 * nnz * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[m.val.dtype] * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, nbytes, flops


def fused_bound(m, d, bwd, epi_rate=TF32X3_FLOPS):
    """Least time (ms) for one B2 (``bwd`` False: read x, w, b, write z) or
    B3 (read ds, dx_dir, w, write h and dx) launch over ``m``: the product's
    bytes and operations as ``bound``, plus the other dense arrays and the
    epilogue GEMM (2 n_rows d^2 f32-faithful operations at ``epi_rate``).
    Returns (ms, 'bytes' or 'operations', bytes, operations)."""
    _, _, nbytes, stream_flops = bound(m, d)
    nbytes += 4 * (d * d + m.n_rows * d * (2 if bwd else 0) + (0 if bwd else d))
    epi_flops = 2 * m.n_rows * d * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (stream_flops / PEAK_FLOPS[m.val.dtype] + epi_flops / epi_rate) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, nbytes, stream_flops + epi_flops


def block_form(m):
    """(stored elements, bytes) of ``m``'s live tiles and strips with their
    block indices: a record of the block operand's size, not a bound."""
    elems = m.nt * m.tile_r * m.tile_c + m.ns * 8 * m.tile_c
    index_bytes = 4 * (m.nt + 3 * m.ns + 2 * (m.n_rows // m.tile_r + 1))
    return elems, elems * m.tiles.element_size() + index_bytes


def check_csr_matches_blocks(name, m):
    """On the card: every entry of ``m``'s edge form sits at its place in a
    live tile or strip with the same value, columns ascend within each row,
    and the blocks hold no other nonzero."""
    rows = torch.repeat_interleave(
        torch.arange(m.n_rows, device=m.col.device), m.row_ptr.diff().long())
    cols = m.col.long()
    ncb = m.n_cols // m.tile_c
    key = (rows // m.tile_r) * ncb + cols // m.tile_c
    tile_keys = m.tile_rb[:m.nt].long() * ncb + m.tile_cb[:m.nt].long()
    ti = torch.searchsorted(tile_keys, key).clamp(max=max(m.nt - 1, 0))
    in_tile = (tile_keys[ti] == key) if m.nt else torch.zeros_like(key, dtype=torch.bool)
    skey = (rows // 8) * ncb + cols // m.tile_c
    strip_keys = m.strip_rb[:m.ns].long() * ncb + m.strip_cb[:m.ns].long()
    si = torch.searchsorted(strip_keys, skey).clamp(max=max(m.ns - 1, 0))
    got = torch.where(
        in_tile,
        m.tiles[ti, rows % m.tile_r, cols % m.tile_c] if m.nt else m.val,
        m.strips[si, rows % 8, cols % m.tile_c] if m.ns else m.val)
    in_strip = (strip_keys[si] == skey) if m.ns else torch.zeros_like(in_tile)
    same_row = rows[1:] == rows[:-1]
    blocks_nnz = (int(torch.count_nonzero(m.tiles[:m.nt]))
                  + int(torch.count_nonzero(m.strips[:m.ns])))
    ok = (bool((in_tile | in_strip).all()) and torch.equal(got, m.val)
          and bool((cols[1:][same_row] > cols[:-1][same_row]).all())
          and blocks_nnz == m.nnz and int(m.row_ptr[-1]) == m.nnz)
    log(f"  {name}: edge form {m.nnz} entries = the blocks' {blocks_nnz} nonzeros, "
        f"value for value {'ok' if ok else 'MISMATCH'}")
    require(ok, f"{name}: the edge form differs from its blocks")


def csr_of(graph, transpose=False):
    """The graph's adjacency (or its transpose) as a torch CSR tensor: the
    library yardstick's operand, never used by the port."""
    ne = graph.n_edges
    rows, cols = graph.receivers[:ne].long(), graph.senders[:ne].long()
    if transpose:
        rows, cols = cols, rows
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), graph.vals[:ne],
                                   (graph.n_nodes, graph.n_nodes),
                                   check_invariants=False).coalesce().to_sparse_csr()


def write_cli_world(root, argv):
    """The CLI's inputs under ``root``: per split, random CNN features (d 128),
    919 sparse binary targets and a Hi-C contact list, written with the
    port's savers where the finetune mode reads them."""
    from chromegcn_tpu_torch.data.artifact import save_graph_edges
    from chromegcn_tpu_torch.data.loader import ChromFeatures, save_chrom_features
    from chromegcn_tpu_torch.data.synthetic import make_hic_edges
    from chromegcn_tpu_torch.main import build_parser, config_from_args

    cfg = config_from_args(build_parser().parse_args(argv))
    os.makedirs(cfg.stage1_run_dir, exist_ok=True)
    os.makedirs(cfg.graph_root, exist_ok=True)
    rng = np.random.default_rng(0)
    for split, (chrom, n, pairs, seed) in CLI_SPLITS.items():
        feats = ChromFeatures(
            forward=rng.normal(size=(n, D)).astype(np.float32),
            backward=rng.normal(size=(n, D)).astype(np.float32),
            target=(rng.random((n, NCLASS)) < 0.05).astype(np.float32),
        )
        save_chrom_features(cfg.feature_path(split), {chrom: feats})
        save_graph_edges(cfg.graph_path(split), {chrom: make_hic_edges(n, pairs, seed=seed)})
    return cfg


def profile_steps(step, t_step_ms, steps=3, groups=PROFILE_GROUPS):
    """Device time per step by kernel over ``steps`` calls of ``step``, and
    the device's idle share of ``t_step_ms`` (a step timed without the
    profiler), summed by ``groups``."""
    rows = traced(step, steps, "a train step", alike=False)
    if rows is None:  # a record, not a check: the run goes on without it
        log(f"  profile of {steps} train steps: not measured, torch.profiler lost device "
            "events in every trace")
        return
    rows = sorted(((us / steps / 1e3, key, count // steps) for key, us, count in rows),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"  profile of {steps} train steps: device busy {busy:.4f} ms per step of "
        f"{t_step_ms:.4f} ms; idle share {max(0.0, 1 - busy / t_step_ms):.3f}")
    sums = {}
    for ms, key, count in rows:
        name = key.lower()
        group = next((g for g, words in groups if any(w in name for w in words)), "other")
        t, n = sums.get(group, (0.0, 0))
        sums[group] = (t + ms, n + count)
    for group, (ms, count) in sorted(sums.items(), key=lambda kv: -kv[1][0]):
        log(f"    {group}: {ms:.4f} ms/step ({100 * ms / busy:.1f}%), {count} launches/step")
    for ms, key, count in rows[:12]:
        log(f"    {ms:9.4f} ms/step {100 * ms / busy:5.1f}%  x{count:<4} {key[:90]}")


def new_state(dropout, impl, fused="off"):
    """A full-width GCN train state on the card, weights from seed 0."""
    from chromegcn_tpu_torch.models.chrome import make_chrome_model
    from chromegcn_tpu_torch.train.finetune import create_chrome_state

    model = make_chrome_model("gcn", nclass=NCLASS, dropout=dropout, layers=LAYERS,
                              nfeat=D, spmm_impl=impl, fused=fused)
    return create_chrome_state(model, "sgd", LR, seed=0, device="cuda")


def check_grads(state, ref_state):
    """Each parameter's gradient within 1e-4 of the reference's scale: sums
    over tens of thousands of rows in another order."""
    for (name, pk), pp in zip(state.model.named_parameters(), ref_state.model.parameters()):
        err = (pk.grad - pp.grad).abs().max().item()
        scale = pp.grad.abs().max().item()
        log(f"  grad {name}: max_abs_err {err:.3e} (tol {1e-4 * scale + 1e-8:.3e})")
        require(err <= 1e-4 * scale + 1e-8, f"grad {name} disagrees")


def no_dropout(model):
    """p = 0 on every nn.Dropout and on the LSTM (the window models' rates are
    the architecture's, with no flag to turn them off)."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        elif isinstance(m, torch.nn.LSTM):
            m.dropout = 0.0
    return model


def trained(model):
    """(name, parameter) of the parameters that train: an LSTM's ``bias_hh``
    stays zero and out of training (flax's cell has one bias per gate)."""
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def train_grads(model, tokens, targets, comp, dtype=torch.float64):
    """The window train step's loss and gradients in ``dtype`` on ``comp``'s
    device, the BCE included (the port's bce_with_logits computes in f32):
    ``model`` (a NonStrandSpecific) is cast in place and left holding the
    grads."""
    model.to(dtype).train()
    model.zero_grad(set_to_none=True)
    _, _, x = model(torch.as_tensor(tokens, device=comp.device), comp)
    z = torch.as_tensor(targets, dtype=dtype, device=comp.device)
    loss = (x.clamp(min=0) - x * z + torch.log1p(torch.exp(-x.abs()))).mean()
    loss.backward()
    return loss.item()


def window_flops(model, batch):
    """Multiply-add operations x 2 of one forward of ``model`` (a window model)
    over ``batch`` sequences, counted from the shapes its convolutions,
    Linears and LSTM see (one forward on the card at batch 2, scaled)."""
    macs = []

    def hook(mod, inputs, out):
        if isinstance(mod, torch.nn.Conv1d):
            macs.append(out.numel() * mod.in_channels * mod.kernel_size[0])
        elif isinstance(mod, torch.nn.Linear):
            macs.append(out.numel() * mod.in_features)
        elif isinstance(mod, torch.nn.LSTM):
            b, t, _ = inputs[0].shape  # batch-first
            per_step = sum(p.numel() for n, p in mod.named_parameters() if n.startswith("weight"))
            macs.append(b * t * per_step)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv1d, torch.nn.Linear, torch.nn.LSTM))]
    was_training = model.training
    try:
        with torch.no_grad():
            model.eval()(torch.zeros((2, model.seq_length), dtype=torch.long,
                                     device=next(model.parameters()).device))
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return 2 * sum(macs) * batch / 2


def write_pipeline_world(argv):
    """The pipeline's inputs: the dataset file (seq 2,000, 919 labels,
    make_window_dataset) and per split a Hi-C contact list per chromosome
    (make_hic_edges(n, 5n)), written with the port's savers. Returns the
    splits."""
    from chromegcn_tpu_torch.data.artifact import save_dataset, save_graph_edges
    from chromegcn_tpu_torch.data.synthetic import make_hic_edges, make_window_dataset
    from chromegcn_tpu_torch.main import build_parser, config_from_args

    cfg = config_from_args(build_parser().parse_args(argv))
    os.makedirs(cfg.dataset_dir, exist_ok=True)
    os.makedirs(cfg.graph_root, exist_ok=True)
    splits = {}
    for i, (split, chroms) in enumerate(PIPELINE_SPLITS.items()):
        splits[split] = make_window_dataset(chroms, n_targets=NCLASS, seq_length=SEQ_LEN, seed=i)
        save_graph_edges(cfg.graph_path(split), {
            chrom: make_hic_edges(n, 5 * n, seed=10 * i + j)
            for j, (chrom, n) in enumerate(chroms.items())})
    save_dataset(cfg.data_path, splits)
    return splits


def cli_config(argv):
    from chromegcn_tpu_torch.main import build_parser, config_from_args

    return config_from_args(build_parser().parse_args(argv))


def run_cli(cli_main, argv):
    """``cli_main(argv)`` on the card; returns (its printed lines, seconds)."""
    import io

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    torch.cuda.synchronize()
    return buf.getvalue().splitlines(), time.perf_counter() - t0


@contextlib.contextmanager
def timed(module, names, seconds):
    """For the block, wrap each function ``names`` of ``module`` so that each
    call adds its host seconds to ``seconds[name]``."""
    saved = {name: getattr(module, name) for name in names}

    def wrap(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return call

    for name, fn in saved.items():
        setattr(module, name, wrap(name, fn))
    try:
        yield seconds
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def same_topk(ours, plain, tie_at_k):
    """Two top-k contact lists (bin1, bin2, value) hold the same contacts:
    equal values as multisets, and the same (bin1, bin2, value) triples, or,
    where ``tie_at_k`` (contacts outside the k share the k-th value), the
    same triples above the k-th value."""
    if not np.array_equal(np.sort(ours[2]), np.sort(plain[2])):
        return False
    floor = ours[2].min() if len(ours[2]) and tie_at_k else -np.inf

    def triples(res):
        keep = res[2] > floor if tie_at_k else np.ones(len(res[2]), bool)
        return sorted(zip(res[0][keep].tolist(), res[1][keep].tolist(), res[2][keep].tolist()))

    return triples(ours) == triples(plain)


def read_logs(run_dir):
    logs = {}
    for split in ("train", "valid", "test"):
        with open(os.path.join(run_dir, f"{split}.log")) as f:
            logs[split] = [[float(v) for v in line.split(",")] for line in f]
    return logs


def rnn_phase(args, smi, graph, x_f, x_r, targets):
    """Phase 14: ChromeRNN at bench scale on the card (see the module doc)."""
    from chromegcn_tpu_torch.models import chrome
    from chromegcn_tpu_torch.ops import _build
    from chromegcn_tpu_torch.ops.sparse import build_chrom_graph
    from chromegcn_tpu_torch.train.finetune import (
        chrome_eval_step, chrome_train_step, create_chrome_state,
    )

    t0 = time.perf_counter()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    log(f"[14 ChromeRNN] {smi}; -chrome_model rnn on the bench chromosome (N_PAD {N_PAD}, "
        f"{N_VALID} valid, the padded rows zero) as one sequence: d {D}, hidden {D // 2}, "
        f"{LAYERS} bidirectional layers, {NCLASS} classes, SGD lr {LR}; f32 parity mode (TF32 "
        "off, the LSTMs on cuDNN's RNN, nothing else on cuDNN)")

    def new_state(device, dropout=0.2, dtype=torch.float32):
        model = chrome.make_chrome_model("rnn", nclass=NCLASS, dropout=dropout, layers=LAYERS,
                                         nfeat=D)
        state = create_chrome_state(model, "sgd", LR, seed=0, device=device)
        state.model.to(dtype)
        return state

    def world(n, device):
        """The first n rows of the bench inputs, the last 2% padding."""
        g = build_chrom_graph("none", n_valid=n - n // 50 if n < N_PAD else N_VALID, n_pad=n,
                              device=device)
        keep = g.node_mask[:, None].to(x_f.device)
        return g, (x_f[:n] * keep).to(device), (x_r[:n] * keep).to(device), targets[:n].to(device)

    # the eval forward on the card against the same weights on the CPU
    g, xf, xr, tg = world(N_PAD, cuda)
    card, host = new_state(cuda), new_state(cpu)
    with torch.no_grad():
        got = card.model(xf, g, train=False)[1].cpu()
        ref = host.model(xf.cpu(), world(N_PAD, cpu)[0], train=False)[1]
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    log(f"  eval forward (one strand) card vs CPU: max_abs_err {err:.3e} ({err / scale:.2e} of "
        "scale; tol 1e-4)")
    require(bool(torch.isfinite(got).all()) and err <= 1e-4 * scale,
            "ChromeRNN's eval forward on the card disagrees with the CPU's")
    del card, host, got, ref

    # one train step, dropout 0: f32 and float64 on the card against float64 on the CPU
    n = RNN_CHECK_N
    states, losses = {}, {}
    for key, device, dtype in (("card", cuda, torch.float32), ("card64", cuda, torch.float64),
                               ("cpu64", cpu, torch.float64)):
        gn, a, b, t = world(n, device)
        states[key] = new_state(device, 0.0, dtype)
        losses[key] = chrome_train_step(states[key], a.to(dtype), b.to(dtype), gn, t.to(dtype),
                                        device=device)[1].item()
    rel = abs(losses["card"] - losses["cpu64"]) / abs(losses["cpu64"])
    log(f"  train step at N {n}, dropout 0: loss card f32 {losses['card']:.8f}, card float64 "
        f"{losses['card64']:.12f}, CPU float64 {losses['cpu64']:.12f}; f32 rel diff {rel:.2e} "
        "(tol 1e-5)")
    require(rel <= 1e-5, "ChromeRNN's f32 train-step loss disagrees with float64's")
    worst32, worst64 = (0.0, ""), (0.0, "")
    for (name, p32), (_, p64c), (_, p64) in zip(*(trained(states[k].model)
                                                  for k in ("card", "card64", "cpu64"))):
        scale = p64.grad.abs().max().item()
        err32 = (p32.grad.double().cpu() - p64.grad).abs().max().item() / scale
        err64 = (p64c.grad.cpu() - p64.grad).abs().max().item() / scale
        require(err32 <= 1e-4, f"ChromeRNN f32 grad {name} is {err32:.2e} of its scale from "
                "float64")
        require(err64 <= 1e-9, f"ChromeRNN float64 grad {name} is {err64:.2e} of its scale from "
                "the CPU's")
        worst32, worst64 = max(worst32, (err32, name)), max(worst64, (err64, name))
    log(f"  grads vs CPU float64: f32 card worst {worst32[1]} at {worst32[0]:.2e} of scale (tol "
        f"1e-4); float64 card worst {worst64[1]} at {worst64[0]:.2e} (tol 1e-9)")
    del states

    # the route: cuDNN's RNN forward and backward, no per-step cell kernel
    gn, a, b, t = world(RNN_TRACE_N, cuda)
    st = new_state(cuda, 0.0)
    chrome_train_step(st, a, b, gn, t)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        chrome_train_step(st, a, b, gn, t)
        torch.cuda.synchronize()
    events = {e.key: e.count for e in prof.key_averages()
              if "rnn" in e.key.lower() or "lstm" in e.key.lower()}
    ops = {k: v for k, v in events.items() if k.startswith("aten::")}
    kernels = sorted({k.split("<")[0].split("(")[0].replace("void ", "")
                      for k in events if not k.startswith(("aten::", "autograd", "Cudnn"))})
    log(f"  the LSTMs in one train step at N {RNN_TRACE_N} (torch.profiler): ops {ops}; "
        f"kernels {kernels}")
    require(ops.get("aten::_cudnn_rnn") and ops.get("aten::_cudnn_rnn_backward"),
            "ChromeRNN's LSTM did not run cuDNN's RNN forward and backward")
    # PyTorch's own path runs aten::_thnn_fused_lstm_cell (and its backward)
    # once per time step; cuDNN's kernels are named LSTM_* and RNN_*
    require(not any("lstm_cell" in k.lower() for k in events),
            "ChromeRNN's LSTM ran per-step cell kernels")

    # timings at bench scale
    st = new_state(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    step = lambda: chrome_train_step(st, xf, xr, g, tg, gen)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _build.LAUNCHES.clear()
    t_train = step_ms(step)
    t_eval = step_ms(lambda: chrome_eval_step(st, xf, xr, g, tg))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    require(not gcn_launches(), f"ChromeRNN launched a GCN kernel: {gcn_launches()}")
    loss = chrome_eval_step(st, xf, xr, g, tg)[0].item()
    require(np.isfinite(loss), "non-finite ChromeRNN loss")
    # each strand's forward runs LAYERS x 2 directions of N_PAD dependent steps
    steps = 2 * LAYERS * N_PAD
    macs = 4 * (D // 2) * (D + D // 2) * steps  # one strand's LSTM forward
    t_bound = 3 * 2 * 2 * macs / PEAK_FLOPS[torch.float32] * 1e3
    log(f"  host ms per step, median (min-max) of 3 after 1 warm-up: train {spread(t_train)} "
        f"(dropout 0.2; eval loss after {loss:.6f}); eval {spread(t_eval)}; peak device memory "
        f"{peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f} above what the process held "
        f"before the steps); {steps} LSTM time steps (layers x directions x N) per strand pass, "
        f"{statistics.median(t_eval) * 1e3 / (2 * steps):.2f} us each in the eval step; the "
        f"LSTMs' train-step FLOPs ({3 * 2 * 2 * macs / 1e9:.1f} GFLOP) take {t_bound:.3f} ms at "
        f"f32's {PEAK_FLOPS[torch.float32] / 1e12:.0f} TFLOP/s")
    if args.profile:
        log("  train step at bench scale:")
        profile_steps(step, statistics.median(t_train), steps=1, groups=RNN_PROFILE_GROUPS)

    # a record: the same step at RNN_CHECK_N with the LSTMs off cuDNN too,
    # PyTorch's cell kernels (one step: it takes seconds)
    gn, a, b, t = world(RNN_CHECK_N, cuda)
    on = step_ms(lambda: chrome_train_step(st, a, b, gn, t, gen))
    via_cudnn = chrome.lstm_forward
    chrome.lstm_forward = lambda lstm, x: lstm(x)[0]
    try:
        off = step_ms(lambda: chrome_train_step(st, a, b, gn, t, gen), steps=1, warmup=0)
    finally:
        chrome.lstm_forward = via_cudnn
    log(f"  record: the train step at N {RNN_CHECK_N}, host ms: cuDNN's RNN {spread(on)}; "
        f"with the LSTMs off cuDNN (PyTorch's per-step cell kernels), one step, "
        f"{off[0]:.1f} (x{off[0] / statistics.median(on):.0f})")
    log(f"  done in {time.perf_counter() - t0:.1f} s")
    return {"train_ms": statistics.median(t_train), "eval_ms": statistics.median(t_eval),
            "peak": peak}


def joint_phase(args, smi, comp):
    """Phase 15: the joint step on the card (see the module doc)."""
    from chromegcn_tpu_torch.data.synthetic import make_hic_edges
    from chromegcn_tpu_torch.models.chrome import make_chrome_model
    from chromegcn_tpu_torch.models.window import make_window_model
    from chromegcn_tpu_torch.ops import _build
    from chromegcn_tpu_torch.ops.sparse import build_chrom_graph
    from chromegcn_tpu_torch.ops.spmm_bsr import attach_bsr
    from chromegcn_tpu_torch.train.finetune import create_chrome_state
    from chromegcn_tpu_torch.train.joint import joint_eval_step, joint_loss, joint_train_step
    from chromegcn_tpu_torch.train.pretrain import create_window_state

    t0 = time.perf_counter()
    cuda = torch.device("cuda")
    log(f"[15 joint step] {smi}; Expecto at the CLI's defaults (seq {SEQ_LEN}, d_model {D}, "
        f"{NCLASS} labels, Adam lr {WINDOW_LR}) and the GCN (Adam lr2 {JOINT_LR2}, dropout 0.2), "
        f"chunks of {JOINT_CHUNK} windows under checkpoint, Hi-C edges make_hic_edges(n, 5n), "
        "f32 parity mode")

    def states(fused="off", dropout=0.2):
        ws = create_window_state(make_window_model("expecto", NCLASS, SEQ_LEN, D), "adam",
                                 WINDOW_LR, seed=0, device=cuda)
        cs = create_chrome_state(make_chrome_model("gcn", nclass=NCLASS, dropout=dropout,
                                                   layers=LAYERS, nfeat=D, fused=fused),
                                 "adam", JOINT_LR2, seed=1, device=cuda)
        return ws, cs

    def world(n, seed):
        rng = np.random.default_rng(seed)
        g = attach_bsr(build_chrom_graph("hic", n_valid=n, n_pad=n, device=cuda,
                                         hic_edges=make_hic_edges(n, 5 * n, seed=seed)),
                       device=cuda)
        tok = torch.as_tensor(rng.integers(0, 4, size=(n, SEQ_LEN)).astype(np.int32),
                              device=cuda)
        tg = torch.as_tensor((rng.random((n, NCLASS)) < 0.05).astype(np.float32), device=cuda)
        return g, tok, tg

    # (a) chunked and checkpointed against one unchunked pass, and fused
    # against unfused, from the same weights, dropout 0
    g, tok, tg = world(JOINT_CHECK_N, 5)

    def loss_and_grads(fused, chunk, remat):
        ws, cs = states(fused, dropout=0.0)
        loss, _ = joint_loss(ws, cs, tok, comp, g, tg, chunk_size=chunk, remat=remat)
        loss.backward()
        grads = {f"{tag}.{n}": p.grad for tag, m in (("window", ws.model), ("chrome", cs.model))
                 for n, p in trained(m) if p.grad is not None}
        return loss.item(), grads

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    runs = {"unchunked": loss_and_grads("off", JOINT_CHECK_N, False)}
    peak_whole = torch.cuda.max_memory_allocated() - held
    runs["chunked"] = loss_and_grads("off", JOINT_CHUNK, True)
    runs["chunked, fused"] = loss_and_grads("on", JOINT_CHUNK, True)
    for name, ref_name in (("chunked", "unchunked"), ("chunked, fused", "chunked")):
        (loss, grads), (ref_loss, ref) = runs[name], runs[ref_name]
        rel = abs(loss - ref_loss) / abs(ref_loss)
        require(set(grads) == set(ref), f"{name}: another set of gradients than {ref_name}'s")
        errs = sorted(((grads[k] - v).abs().max().item() / max(v.abs().max().item(), 1e-30), k)
                      for k, v in ref.items())
        log(f"  {JOINT_CHECK_N} windows, {name} vs {ref_name}: loss {loss:.8f} vs "
            f"{ref_loss:.8f}, rel diff {rel:.2e} (tol 1e-5); {len(errs)} grads of both models, "
            f"worst {errs[-1][1]} at {errs[-1][0]:.2e} of scale (tol 1e-4)")
        require(rel <= 1e-5 and errs[-1][0] <= 1e-4, f"the joint step {name} disagrees with "
                f"{ref_name}")
    log(f"  the unchunked pass (states, forward and backward) peaked {peak_whole / 2**30:.2f} "
        "GiB above what the process held before it")
    del runs
    torch.cuda.empty_cache()
    if args.profile:
        ws, cs = states()
        log(f"  joint train step at {JOINT_CHECK_N} windows:")
        train = lambda: joint_train_step(ws, cs, tok, comp, g, tg, chunk_size=JOINT_CHUNK)  # noqa
        profile_steps(train, statistics.median(step_ms(train)), steps=1,
                      groups=PROFILE_GROUPS[:2] + WINDOW_PROFILE_GROUPS)
        del ws, cs

    # (b) timings at JOINT_N windows, unfused and fused
    g, tok, tg = world(JOINT_N, 6)
    expected = {"off": ({"bsr_spmm": 8}, {"bsr_spmm": 4}),
                "on": ({"gcn_fused_fwd": 4, "gcn_fused_bwd": 4}, {"gcn_fused_fwd": 4})}
    out = {}
    for fused, (train_per_step, eval_per_step) in expected.items():
        ws, cs = states(fused)
        gen = torch.Generator(device=cuda).manual_seed(0)
        train = lambda: joint_train_step(ws, cs, tok, comp, g, tg, gen, JOINT_CHUNK)  # noqa
        evaluate = lambda: joint_eval_step(ws, cs, tok, comp, g, tg, JOINT_CHUNK)  # noqa
        train()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _build.LAUNCHES.clear()
        t_train = step_ms(train, warmup=0)
        train_counts = gcn_launches()
        peak = torch.cuda.max_memory_allocated()
        evaluate()
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t_eval = step_ms(evaluate, warmup=0)
        eval_counts = gcn_launches()
        loss, probs = evaluate()
        require(np.isfinite(loss.item()) and probs.shape == (JOINT_N, NCLASS)
                and bool(torch.isfinite(probs).all()), "non-finite joint eval")
        ms = statistics.median(t_train)
        log(f"  -gcn_fused {fused}, {JOINT_N} windows: train {spread(t_train)} ms = "
            f"{JOINT_N / ms * 1e3:.1f} windows/s; eval {spread(t_eval)} ms; peak device memory "
            f"{peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f} above what the process held "
            f"before the steps); launches per train step "
            f"{ {k: v / 3 for k, v in train_counts.items()} }, per eval step "
            f"{ {k: v / 3 for k, v in eval_counts.items()} } (host ms, median (min-max) of 3 "
            "after 1 warm-up)")
        require(train_counts == {k: 3 * v for k, v in train_per_step.items()},
                f"-gcn_fused {fused}: expected {train_per_step} launches per joint train step")
        require(eval_counts == {k: 3 * v for k, v in eval_per_step.items()},
                f"-gcn_fused {fused}: expected {eval_per_step} launches per joint eval step")
        out[fused] = {"train_ms": ms, "eval_ms": statistics.median(t_eval), "peak": peak}
        if fused == "off":
            # a record, not the port's mode: the fast mode (cuDNN and TF32)
            torch.backends.cudnn.enabled = True
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            try:
                fast = step_ms(train, steps=1)
            finally:
                torch.backends.cudnn.enabled = False
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
            log(f"  record: the same train step in the fast mode (cuDNN and TF32), 1 after 1 "
                f"warm-up: {fast[0]:.1f} ms = {JOINT_N / fast[0] * 1e3:.1f} windows/s")
        del ws, cs
    log(f"  done in {time.perf_counter() - t0:.1f} s")
    return out


def launches_per_product(op):
    """B1 launches one product over ``op`` makes, per direction."""
    from chromegcn_tpu_torch.ops.spmm_bsr import BSROperator, BSRPanelOperator

    if isinstance(op, BSROperator):
        return 1
    if isinstance(op, BSRPanelOperator):
        require(len(op.fwd) == len(op.bwd), "panels: the two directions differ in count")
        return len(op.fwd)
    return 1 + (op.dense is not None)


def bce_phase(smi, launches):
    """The BCE kernels (``bce_sum``, ``bce_sum_bwd``) alone at the main
    path's shapes, bench (N_PAD 50,176) and full chr1 (249,856), 919 labels,
    the padded tail masked: the sum within rel 1e-6 of the plain formula in
    float64 and the same bits over 3 calls; the gradient under a cotangent
    of -0.37 of the mean's within 1e-6 of |g| of the plain closed form.
    Then at full chr1, CUDA events around the loss and its gradient through
    the kernels, the plain formula under autograd and the library's
    binary_cross_entropy_with_logits (row weights, a sum), each kernel
    alone, and their bounds. Returns the kernels line's row; ``launches``
    are phase 5's."""
    import torch.nn.functional as F

    from chromegcn_tpu_torch.ops.bce_fused import (
        BCESum, bce_grad_plain, bce_sum, bce_sum_bwd, bce_sum_plain,
    )

    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(18)
    rel_errs, grad_errs = [], []
    for n_pad, n_valid in ((N_PAD, N_VALID), (FULL_PAD, FULL_VALID)):
        x = 3 * torch.randn(n_pad, NCLASS, device=cuda, generator=gen)
        x.view(-1)[::97] = 0.0
        x.view(-1)[1::89] = 60.0
        x.view(-1)[2::83] = -60.0
        z = (torch.rand(n_pad, NCLASS, device=cuda, generator=gen) < 0.05).float()
        m = (torch.arange(n_pad, device=cuda) < n_valid).float()
        sums = [bce_sum(x, z, m) for _ in range(3)]
        same_bits = all(torch.equal(v, sums[0]) for v in sums)
        ref = bce_sum_plain(x.double(), z.double(), m.double()).item()
        rel = abs(sums[0].item() - ref) / abs(ref)
        g = torch.tensor(-0.37 / (n_valid * NCLASS), device=cuda)
        dx = bce_sum_bwd(x, z, m, g)
        err = (dx - bce_grad_plain(x, z, m, g)).abs().max().item()
        tail = bool(dx[n_valid:].any())
        del dx
        log(f"  BCE kernels at {n_pad} x {NCLASS}, {n_valid} rows valid: sum rel diff {rel:.2e} "
            f"from float64 (tol 1e-6), 3 calls bit-equal {same_bits}; gradient max_abs_err "
            f"{err:.3e} ({err / abs(g.item()):.2e} of |g|, tol 1e-6)")
        require(same_bits, "the BCE sum does not repeat bit for bit")
        require(rel <= 1e-6, f"the BCE sum at {n_pad} rows is {rel:.2e} from float64")
        require(err <= 1e-6 * abs(g.item()),
                f"the BCE gradient at {n_pad} rows is {err:.3e} from the closed form")
        require(not tail, "the BCE gradient wrote into the masked rows")
        rel_errs.append(rel)
        grad_errs.append(err)

    # timed at the loop's last shape, full chr1
    def with_grad(loss):
        def run():
            xg = x.detach().requires_grad_(True)
            loss(xg).backward(g)
        return run

    lib_value = F.binary_cross_entropy_with_logits(x, z, weight=m[:, None], reduction="sum")
    log(f"  library binary_cross_entropy_with_logits (weight the row mask, sum) at full chr1: "
        f"rel diff {abs(lib_value.item() - ref) / abs(ref):.2e} from float64 (a record)")
    fns = {
        "kernels": with_grad(lambda xg: BCESum.apply(xg, z, m)),
        "plain": with_grad(lambda xg: bce_sum_plain(xg, z, m)),
        "library": with_grad(lambda xg: F.binary_cross_entropy_with_logits(
            xg, z, weight=m[:, None], reduction="sum")),
        "sum": lambda: bce_sum(x, z, m),
        "grad": lambda: bce_sum_bwd(x, z, m, g),
    }
    t = cuda_ms(fns)
    ms = {k: statistics.median(v) for k, v in t.items()}
    tensor_ms = x.numel() * 4 / HBM_BYTES_PER_S * 1e3
    bounds = {"sum": 2 * tensor_ms, "grad": 3 * tensor_ms, "kernels": 5 * tensor_ms}
    log(f"  BCE loss and gradient at {FULL_PAD} x {NCLASS} ({smi}), CUDA-event ms a call "
        f"(median (min-max) of 5 loops of 20 in turns): kernels {spread(t['kernels'])} "
        f"(bound {bounds['kernels']:.4f}, x and z read twice and dx written once at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); plain formula with autograd {spread(t['plain'])}; "
        f"library binary_cross_entropy_with_logits {spread(t['library'])}; alone: sum "
        f"{spread(t['sum'])} (bound {bounds['sum']:.4f}), gradient {spread(t['grad'])} "
        f"(bound {bounds['grad']:.4f})")
    return {
        "name": "bce_fused",
        "route": "cuda",
        "source": "chromegcn_tpu_torch/csrc/bce_fused.cu",
        "replaces": "chromegcn_tpu/train/loss.py:17",
        # phase 5: the unfused main path's train and eval steps
        "launches": launches["bce_sum"] + launches["bce_sum_bwd"],
        "launches_sum": launches["bce_sum"],
        "launches_grad": launches["bce_sum_bwd"],
        "max_abs_err": max(grad_errs),
        "sum_rel_err": max(rel_errs),
        "shape": [FULL_PAD, NCLASS],
        # the loss and its gradient at full chr1, CUDA events
        "ms": ms["kernels"],
        "event_ms": ms["kernels"],
        "ms_sum": ms["sum"],
        "ms_grad": ms["grad"],
        "plain_ms": ms["plain"],
        "bound_ms": bounds["kernels"],
        "bound_ms_sum": bounds["sum"],
        "bound_ms_grad": bounds["grad"],
        "bound_by": "HBM bytes",
        "library_ms": ms["library"],
    }


def fullscale_phase(args, smi, bench_graph, bench_device_ms):
    """Phase 17: the flat, panelled and hybrid forms at full chr1 scale (see
    the module doc). ``bench_device_ms``: phase 10's device ms of B1 over
    the bench graph's two directions ({'bench': fwd, 'bench bwd': bwd}), for
    the cost model's fit. Returns B1's numbers for the kernels line."""
    from chromegcn_tpu_torch.data.synthetic import make_hic_edges
    from chromegcn_tpu_torch.ops import _build
    from chromegcn_tpu_torch.ops import spmm_hybrid as hy
    from chromegcn_tpu_torch.ops.gcn_fused import (
        fused_bwd, fused_bwd_plain, fused_fwd, fused_fwd_plain,
    )
    from chromegcn_tpu_torch.ops.sparse import build_chrom_graph
    from chromegcn_tpu_torch.ops.spmm import spmm_operator
    from chromegcn_tpu_torch.ops.spmm_bsr import (
        bsr_from_graph, bsr_matmul, bsr_matmul_plain, bsr_panels_from_graph, csr_matmul,
        panel_bounds, panel_matmul,
    )
    from chromegcn_tpu_torch.train.finetune import chrome_eval_step, chrome_train_step

    cuda = torch.device("cuda")
    t0 = time.perf_counter()
    s, r, v = make_hic_edges(FULL_VALID, FULL_PAIRS, **FULL_EDGES)
    graph = build_chrom_graph("hic", n_valid=FULL_VALID, n_pad=FULL_PAD, hic_edges=(s, r, v),
                              device=cuda)
    t_world = time.perf_counter() - t0
    build_s = {}
    t0 = time.perf_counter()
    flat = bsr_from_graph(graph, device=cuda)
    torch.cuda.synchronize()
    build_s["flat"] = time.perf_counter() - t0
    bounds = panel_bounds(FULL_PAD, D)
    t0 = time.perf_counter()
    panels = bsr_panels_from_graph(graph, d_model=D, device=cuda)
    torch.cuda.synchronize()
    build_s["panelled"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hyb = hy.hybrid_from_graph(graph, device=cuda)
    torch.cuda.synchronize()
    build_s["hybrid"] = time.perf_counter() - t0
    tpu_model = hy.estimate_costs_ns(graph, d=D)
    log(f"[17 full chr1 scale] {smi}; make_hic_edges({FULL_VALID}, {FULL_PAIRS}, "
        f"{', '.join(f'{k}={v}' for k, v in FULL_EDGES.items())}), N_PAD {FULL_PAD}: "
        f"{graph.n_edges} directed edges, world built in {t_world:.1f} s")
    log(f"  host build s: flat {build_s['flat']:.1f}, panelled {build_s['panelled']:.1f} "
        f"(panel_bounds {bounds}: {len(panels.fwd)} live panels fwd, {len(panels.bwd)} bwd), "
        f"hybrid {build_s['hybrid']:.1f}")
    log(f"  flat: {flat.fwd.nnz} nonzeros a direction, fwd nt {flat.fwd.nt} ns {flat.fwd.ns}, "
        f"bwd nt {flat.bwd.nt} ns {flat.bwd.ns}; hybrid: {hyb.n_stragglers} straggler edges, "
        f"dense part {hyb.dense.fwd.nnz} nonzeros in {hyb.dense.fwd.nt} tiles; the "
        f"reference's cost model (TPU constants): {tpu_model['n_straggler_edges']} straggler "
        f"edges, {tpu_model['n_dense_tiles']} dense tiles. Record, the reference's TPU run "
        f"(HYBRID_r05.json): {FULL_TPU_RECORD}")
    require(hyb.dense is not None, "the full-scale world has no dense region")
    require(hyb.n_stragglers + hyb.dense.fwd.nnz == flat.fwd.nnz == graph.n_edges,
            "the hybrid's two parts do not hold the graph's nonzeros")

    gen = torch.Generator(device=cuda).manual_seed(17)
    x = torch.randn(FULL_PAD, D, device=cuda, generator=gen)
    ct = torch.randn(FULL_PAD, D, device=cuda, generator=gen)
    errs = {}
    # B1 against its plain version over every form's matrices
    mats = {f"flat {k}": getattr(flat, k) for k in ("fwd", "bwd")}
    for k in ("fwd", "bwd"):
        for (pr, pc), m in zip(getattr(panels, f"{k}_coords"), getattr(panels, k)):
            mats[f"panel {k} ({pr},{pc})"] = m
        mats[f"hybrid dense {k}"] = getattr(hyb.dense, k)
    for name, m in mats.items():
        xs = x[:m.n_cols] if name.startswith("panel") else x
        ref = bsr_matmul_plain(m, xs)
        poison_allocator((m.n_rows, D))
        errs[name] = compare(f"B1 {name} d={D}", bsr_matmul(m, xs), ref)
        del ref
    for k, (gi, si, vals) in (("fwd", (hyb.fs, hyb.fr, hyb.fv)), ("bwd", (hyb.bs, hyb.br, hyb.bv))):
        ref = hy.straggler_matmul_plain(gi, si, vals, FULL_PAD, x)
        poison_allocator((FULL_PAD, D))
        errs[f"hybrid stragglers {k}"] = compare(
            f"B1 hybrid stragglers {k} (edge form) vs index_select + index_add_ d={D}",
            csr_matmul(getattr(hyb, f"{k}_edges"), x), ref)
        del ref
    # the panelled and hybrid products against the flat one: A x and A^T g
    # through each form's autograd op
    flat_out = {}
    for name, op in (("flat", flat), ("panelled", panels), ("hybrid", hyb)):
        xg = x.clone().requires_grad_()
        out = spmm_operator(op, xg)
        out.backward(ct)
        if name == "flat":
            flat_out = {"A x": out.detach(), "A^T g": xg.grad}
            continue
        errs[f"{name} A x"] = compare(f"{name} A x vs flat", out.detach(), flat_out["A x"])
        errs[f"{name} A^T g"] = compare(f"{name} A^T g vs flat", xg.grad, flat_out["A^T g"])
    del flat_out, xg, out
    torch.cuda.synchronize()

    # the train step on the hybrid against the flat one, from the same weights
    g_flat = graph.replace(bsr=flat)
    g_hyb = graph.replace(bsr=hyb)
    rng = np.random.default_rng(17)
    x_f = torch.from_numpy(rng.normal(size=(FULL_PAD, D)).astype(np.float32)).to(cuda)
    x_r = torch.from_numpy(rng.normal(size=(FULL_PAD, D)).astype(np.float32)).to(cuda)
    targets = torch.from_numpy((rng.random((FULL_PAD, NCLASS)) < 0.1).astype(np.float32)).to(cuda)
    log("  hybrid train step vs flat train step, dropout 0, same weights:")
    state_h, state_b = new_state(0.0, "pallas"), new_state(0.0, "pallas")
    _, loss_h, _ = chrome_train_step(state_h, x_f, x_r, g_hyb, targets)
    _, loss_b, _ = chrome_train_step(state_b, x_f, x_r, g_flat, targets)
    rel = abs(loss_h.item() - loss_b.item()) / abs(loss_b.item())
    log(f"  loss hybrid {loss_h.item():.8f} flat {loss_b.item():.8f} rel diff {rel:.2e} (tol 1e-5)")
    require(rel <= 1e-5, "hybrid and flat train-step losses disagree")
    check_grads(state_h, state_b)
    del state_h, state_b

    # the steps: unfused flat, unfused hybrid, fused flat; launches and peak
    state_u, state_fu = new_state(0.2, "pallas"), new_state(0.2, "pallas", "on")
    require(state_fu.model._use_fused(x_f, g_flat), "the full-scale model does not fuse")
    require(not state_fu.model._use_fused(x_f, g_hyb), "the fused model fuses on the hybrid")
    gen_step = torch.Generator(device=cuda).manual_seed(0)
    paths = {"flat": (state_u, g_flat), "hybrid": (state_u, g_hyb), "fused": (state_fu, g_flat)}
    want = {"flat": ({"bsr_spmm": 8}, {"bsr_spmm": 4}),
            "hybrid": ({"bsr_spmm": 16}, {"bsr_spmm": 8}),
            "fused": ({"gcn_fused_fwd": 4, "gcn_fused_bwd": 4}, {"gcn_fused_fwd": 4})}
    counts, peaks = {}, {}
    for name, (st, g) in paths.items():
        for kind, step in (("train", lambda: chrome_train_step(st, x_f, x_r, g, targets,
                                                               gen_step)),
                           ("eval", lambda: chrome_eval_step(st, x_f, x_r, g, targets))):
            step()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _build.LAUNCHES.clear()
            out = step()
            torch.cuda.synchronize()
            counts[name, kind] = gcn_launches()
            peaks[name, kind] = (torch.cuda.max_memory_allocated() - held) / 2**30
            require(all(bool(torch.isfinite(t).all()) for t in out[-2:]),
                    f"{name} {kind} step: non-finite loss or probs")
            del out
    steps = host_ms({f"{name} {kind}": (
        (lambda st=st, g=g: chrome_train_step(st, x_f, x_r, g, targets, gen_step))
        if kind == "train" else (lambda st=st, g=g: chrome_eval_step(st, x_f, x_r, g, targets)))
        for name, (st, g) in paths.items() for kind in ("train", "eval")})
    edges_per_step = graph.n_edges * LAYERS * 2 * 2
    for name in paths:
        t_train = statistics.median(steps[f"{name} train"])
        log(f"  {name}: host ms per step, median (min-max) of 5 loops of 5 in turns: train "
            f"{spread(steps[f'{name} train'])} = {edges_per_step / t_train / 1e3:.1f} M edges/s, "
            f"eval {spread(steps[f'{name} eval'])}; peak device memory above what the process "
            f"held {peaks[name, 'train']:.2f} GiB (train), {peaks[name, 'eval']:.2f} GiB (eval); "
            f"launches per step {counts[name, 'train']} (train), {counts[name, 'eval']} (eval)")
        require((counts[name, "train"], counts[name, "eval"]) == want[name],
                f"{name}: expected launches {want[name]} per train and eval step")
    if args.profile:
        for name in paths:
            st, g = paths[name]
            log(f"  {name} train step:")
            profile_steps(lambda: chrome_train_step(st, x_f, x_r, g, targets, gen_step),
                          statistics.median(steps[f"{name} train"]))
    del state_u, state_fu

    # B1's time over each form, its share of the product's bound, and the
    # card cost model fitted to B1's launches. CUDA events: these calls run
    # 0.06-1 ms, far above the host's launch gaps, and at this scale, in a
    # long run, torch.profiler lost kernels from every trace (``traced``)
    y, z = torch.randn(FULL_PAD, D, device=cuda), torch.randn(FULL_PAD, D, device=cuda)
    empty = dataclasses.replace(hyb.fwd_edges, row_ptr=torch.zeros_like(hyb.fwd_edges.row_ptr),
                                col=hyb.fwd_edges.col[:0], val=hyb.fwd_edges.val[:0])
    adj_csr = csr_of(graph)
    fns = {
        "flat": lambda: bsr_matmul(flat.fwd, x),
        "panelled": lambda: panel_matmul(panels.fwd, panels.fwd_coords, panels.bounds, x),
        "hybrid": lambda: hy.hybrid_matmul(hyb, x, "fwd"),
        "hybrid dense": lambda: bsr_matmul(hyb.dense.fwd, x),
        "hybrid stragglers": lambda: csr_matmul(hyb.fwd_edges, x),
        "add": lambda: y.add_(z),
        "library": lambda: torch.sparse.mm(adj_csr, x),
        "flat bwd": lambda: bsr_matmul(flat.bwd, x),
        "hybrid dense bwd": lambda: bsr_matmul(hyb.dense.bwd, x),
        "hybrid stragglers bwd": lambda: csr_matmul(hyb.bwd_edges, x),
        "empty": lambda: csr_matmul(empty, x),
    }
    t = cuda_ms(fns)
    med = {k: statistics.median(v) for k, v in t.items()}
    med.update(bench_device_ms)
    b_ms, b_by, b_bytes, _ = bound(flat.fwd, D)
    log(f"  B1 ms per product, A x at d {D} (CUDA events, median (min-max) of 5 loops of 20 "
        f"in turns); the product's bound {b_ms:.4f} ms by {b_by} ({b_bytes / 1e6:.1f} MB)")
    for name in ("flat", "panelled", "hybrid", "library"):
        launches = {"flat": 1, "panelled": len(panels.fwd), "hybrid": 2, "library": 0}[name]
        log(f"    {name}: {spread(t[name])} ms ({launches} B1 launches), "
            f"{100 * b_ms / med[name]:.1f}% of the bound")
    for name, m in (("hybrid dense", hyb.dense.fwd), ("hybrid stragglers", hyb.fwd_edges)):
        bm, by, _, _ = bound(m, D)
        log(f"    {name}: {spread(t[name])} ms, {m.nnz} nonzeros, its own bound {bm:.4f} ms by "
            f"{by} ({100 * bm / med[name]:.1f}%)")
    add_bytes = 3 * FULL_PAD * D * 4
    log(f"    the hybrid's add: {spread(t['add'])} ms, its bound "
        f"{add_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms by bytes")
    # fit one launch's time to launch + a_local n_local + a_scattered
    # n_scattered + b rows (d 128), the nonzeros split by the hybrid's test,
    # every constant >= 0 (non-negative least squares): a free intercept
    # comes out negative, and the model would then favour the form with more
    # launches on graphs smaller than those measured. The bench graph's
    # points are phase 10's device times (its 0.03 ms launches are near the
    # host's launch gaps, which CUDA events would count)
    def split(g):
        e = g.n_edges
        n_local = int(hy._dense_selection(g.senders[:e].cpu().numpy(),
                                          g.receivers[:e].cpu().numpy(), g.n_nodes, 128, 128,
                                          hy.DENSE_REGION_EDGES).sum())
        return n_local, e - n_local

    full_split, bench_split = split(graph), split(bench_graph)
    points = [("flat", full_split, FULL_PAD), ("flat bwd", full_split, FULL_PAD),
              ("hybrid dense", (full_split[0], 0), FULL_PAD),
              ("hybrid dense bwd", (full_split[0], 0), FULL_PAD),
              ("hybrid stragglers", (0, full_split[1]), FULL_PAD),
              ("hybrid stragglers bwd", (0, full_split[1]), FULL_PAD),
              ("empty", (0, 0), FULL_PAD),
              ("bench", bench_split, bench_graph.n_nodes),
              ("bench bwd", bench_split, bench_graph.n_nodes)]
    a = np.array([[1.0, nl, ns_, rows] for _, (nl, ns_), rows in points])
    ns = np.array([med[k] * 1e6 for k, _, _ in points])
    from scipy.optimize import nnls

    (c_launch, c_local, c_scat, c_row), _ = nnls(a, ns)
    c_add = med["add"] * 1e6 / FULL_PAD
    log(f"  card cost model fitted this run (B1 ns = launch + a_local n_local + a_scattered "
        f"n_scattered + b rows, d {D}, non-negative least squares over the launches below; "
        f"local: in a dense region): launch "
        f"{c_launch:.1f} ns, a_local {c_local:.5f} ns, a_scattered {c_scat:.5f} ns, b "
        f"{c_row:.5f} ns/row; add {c_add:.5f} ns/row. In the code: launch "
        f"{hy._CARD_LAUNCH_NS}, a_local {hy._CARD_NS_PER_LOCAL_NNZ}, a_scattered "
        f"{hy._CARD_NS_PER_SCATTERED_NNZ}, b {hy._CARD_NS_PER_ROW}, add "
        f"{hy._CARD_ADD_NS_PER_ROW}")
    for (k, (nl, ns_), rows), y_ns in zip(points, ns):
        fit = c_launch + c_local * nl + c_scat * ns_ + c_row * rows
        log(f"    {k}: {nl} local + {ns_} scattered nonzeros, {rows} rows: measured "
            f"{y_ns / 1e3:.4f} us, fit {fit / 1e3:.4f} us, the code's model "
            f"{hy.b1_cost_ns(nl, ns_, rows, D) / 1e3:.4f} us")
    bench_card = hy.card_costs_ns(bench_graph, d=D)
    log(f"  attach_auto('auto') picks {hy.auto_form(bench_graph, D)!r} at bench scale (model: "
        f"flat {bench_card['bsr_ns'] / 1e6:.4f} ms, hybrid {bench_card['hybrid_ns'] / 1e6:.4f} "
        f"ms a product)")
    card = hy.card_costs_ns(graph, d=D)
    log(f"  cost model in the code vs measured, one product: flat {card['bsr_ns'] / 1e6:.4f} "
        f"vs {med['flat']:.4f} ms; hybrid {card['hybrid_ns'] / 1e6:.4f} vs {med['hybrid']:.4f} "
        f"ms. attach_auto('auto') picks {hy.auto_form(graph, D)!r} at full scale; the "
        f"reference's TPU model: bsr {tpu_model['bsr_ns'] / 1e6:.4f} ms, hybrid "
        f"{tpu_model['hybrid_ns'] / 1e6:.4f} ms (a TPU's, a record)")
    require(all(np.isfinite([c_launch, c_local, c_scat, c_row, c_add])),
            "the cost fit is not finite")

    # B2 and B3 alone over the flat form, against their plain versions, then
    # timed as B1 is (CUDA events), with device times where a trace completes
    w, bias = torch.randn(D, D, device=cuda, generator=gen) / D ** 0.5, 0.1 * torch.randn(
        D, device=cuda, generator=gen)
    ds, dx_dir = torch.randn(FULL_PAD, D, device=cuda), torch.randn(FULL_PAD, D, device=cuda)
    ref = fused_fwd_plain(flat.fwd, x, w, bias)
    poison_allocator((FULL_PAD, D))
    errs_fused = {"gcn_fused_fwd": compare(f"B2 z at full scale d={D}",
                                           fused_fwd(flat.fwd, x, w, bias), ref)}
    h_ref, dx_ref = fused_bwd_plain(flat.bwd, ds, dx_dir, w)
    poison_allocator((2 * FULL_PAD, D))
    h, dx = fused_bwd(flat.bwd, ds, dx_dir, w)
    errs_fused["gcn_fused_bwd"] = max(
        compare(f"B3 h at full scale d={D}", h, h_ref),
        compare(f"B3 dx at full scale d={D} (atol of scale)", dx, dx_ref, scaled=True))
    del ref, h_ref, dx_ref, h, dx
    adj_t_csr = csr_of(graph, transpose=True)
    fused_fns = {
        "B2": lambda: fused_fwd(flat.fwd, x, w, bias),
        "B2 plain": lambda: fused_fwd_plain(flat.fwd, x, w, bias),
        "B2 library": lambda: torch.tanh(torch.sparse.mm(adj_csr, x) @ w + bias),
        "B3": lambda: fused_bwd(flat.bwd, ds, dx_dir, w),
        "B3 plain": lambda: fused_bwd_plain(flat.bwd, ds, dx_dir, w),
        "B3 library": lambda: torch.addmm(dx_dir, torch.sparse.mm(adj_t_csr, ds), w.T),
    }
    t = cuda_ms(fused_fns)
    fused_rows = {}
    for kernel, key, m, bwd in (("gcn_fused_fwd", "B2", flat.fwd, False),
                                ("gcn_fused_bwd", "B3", flat.bwd, True)):
        fb_ms, fb_by, fb_bytes, _ = fused_bound(m, D, bwd)
        for _ in range(3):
            fused_fns[key]()
        torch.cuda.synchronize()
        rows = traced(fused_fns[key], 20, f"{key} at full scale")
        dev = None if rows is None else sum(us for _, us, _ in rows) / 20 / 1e3
        ms = statistics.median(t[key])
        fused_rows[kernel] = {"event_ms_fullscale": ms, "device_ms_fullscale": dev,
                              "plain_ms_fullscale": statistics.median(t[f"{key} plain"]),
                              "library_ms_fullscale": statistics.median(t[f"{key} library"]),
                              "bound_ms_fullscale": fb_ms,
                              "max_abs_err_fullscale": errs_fused[kernel]}
        log(f"  {key} alone at full scale, d {D}, ms per call (CUDA events, median (min-max) of "
            f"5 loops of 20 in turns): kernel {spread(t[key])}; plain {spread(t[f'{key} plain'])}; "
            f"library composition {spread(t[f'{key} library'])}; device "
            f"{'not measured (no complete trace)' if dev is None else f'{dev:.4f}'}; bound "
            f"{fb_ms:.4f} ms by {fb_by} ({fb_bytes / 1e6:.1f} MB): kernel at "
            f"{100 * fb_ms / ms:.1f}% (events)")
        require(fb_ms / ms <= 1.0, f"{key} above 100% of its bound")
    del ds, dx_dir, adj_t_csr
    return {
        "fused_fullscale": fused_rows,
        "event_ms_fullscale": med["flat"],
        "bound_ms_fullscale": b_ms,
        "launches_hybrid_train_step": counts["hybrid", "train"]["bsr_spmm"],
        "max_abs_err_fullscale": max(errs.values()),
        "graph": graph,
        "flat": flat,
    }


def analysis_phase(smi, bench_graph, x_f, x_r, targets, comp):
    """Phase 18: the analysis functions and the variant scores on the card
    (see the module doc). Returns B1's launches in the bench-scale analysis."""
    import copy

    from chromegcn_tpu_torch.analysis.saliency import (
        adjacency_saliency, feature_saliency, gate_values, refined_embeddings,
        tf_knockout_matrix,
    )
    from chromegcn_tpu_torch.data.synthetic import make_hic_edges
    from chromegcn_tpu_torch.models.window import make_window_model
    from chromegcn_tpu_torch.ops import _build
    from chromegcn_tpu_torch.ops.sparse import build_chrom_graph
    from chromegcn_tpu_torch.ops.spmm_bsr import attach_bsr
    from chromegcn_tpu_torch.pipeline.genome import Fasta, write_fasta
    from chromegcn_tpu_torch.pipeline.variants import score_snp_table
    from chromegcn_tpu_torch.train.pretrain import create_window_state

    cuda = torch.device("cuda")
    t0 = time.perf_counter()
    label = 7
    state = new_state(0.2, "auto")
    model = state.model
    rng = np.random.default_rng(18)
    with torch.no_grad():  # running statistics away from the identity
        model.batch_norm.running_mean.copy_(torch.as_tensor(rng.normal(size=D)))
        model.batch_norm.running_var.copy_(torch.as_tensor(rng.uniform(0.5, 2.0, size=D)))
    model64 = copy.deepcopy(model).double().cpu()

    # at ANALYSIS_N nodes: the card (B1 over the BSR form; the COO path for
    # the edge values) against the CPU in float64 (the COO path)
    n_valid = ANALYSIS_N - 96
    g_cpu = build_chrom_graph("hic", n_valid=n_valid, n_pad=ANALYSIS_N, device="cpu",
                              hic_edges=make_hic_edges(n_valid, 5 * n_valid, seed=18))
    g_card = attach_bsr(g_cpu, device=cuda)
    x = rng.normal(size=(ANALYSIS_N, D))
    x32 = torch.as_tensor(x, dtype=torch.float32, device=cuda)
    fns = {
        "feature_saliency": lambda m, xx, g: feature_saliency(m, xx, g, label),
        "gate_values g1": lambda m, xx, g: gate_values(m, xx, g)[0],
        "gate_values g2": lambda m, xx, g: gate_values(m, xx, g)[1],
        "refined_embeddings": lambda m, xx, g: refined_embeddings(m, xx, g),
        "adjacency_saliency": lambda m, xx, g: adjacency_saliency(m, xx, g, label),
    }
    log(f"[18 analysis] {smi}; at N {ANALYSIS_N} ({g_cpu.n_edges} edges), label {label}: the "
        "card (f32, B1; the COO path for the edge values) vs the CPU in float64, within 1e-4 "
        "of scale")
    for name, fn in fns.items():
        _build.LAUNCHES.clear()
        got = fn(model, x32, g_card)
        torch.cuda.synchronize()
        b1 = _build.LAUNCHES["bsr_spmm"]
        ref = fn(model64, torch.as_tensor(x), g_cpu)
        scale = float(np.abs(ref).max())
        err = float(np.abs(got - ref).max())
        log(f"  {name}: {got.shape}, max_abs_err {err:.3e} ({err / scale:.2e} of scale "
            f"{scale:.3e}); B1 launches {b1}")
        require(got.shape == ref.shape and np.isfinite(got).all(), f"{name}: shape or finite")
        require(err <= 1e-4 * scale, f"{name}: the card disagrees with float64")
        require(b1 == {"feature_saliency": 4, "adjacency_saliency": 0}.get(name, 2),
                f"{name}: unexpected B1 launch count {b1}")

    # at bench scale: timed, with their B1 launches
    bench_bsr = attach_bsr(bench_graph, device=cuda)
    timed, b1_bench = {}, 0
    for name, fn in fns.items():
        if name == "gate_values g2":
            continue
        _build.LAUNCHES.clear()
        fn(model, x_f, bench_bsr)
        torch.cuda.synchronize()
        launches = _build.LAUNCHES["bsr_spmm"]
        b1_bench += launches
        timed[name] = (step_ms(lambda: fn(model, x_f, bench_bsr)), launches)
    log(f"  bench scale (N_PAD {N_PAD}, {bench_graph.n_edges} edges), host ms, median "
        "(min-max) of 3 after 1 warm-up, results back on the host: " + "; ".join(
            f"{name} {spread(t)} ({b1} B1)" for name, (t, b1) in timed.items()))
    labels = [int(i) for i in np.argsort(-targets[:, :32].sum(0).cpu().numpy())[:3]]
    t1 = time.perf_counter()
    ko = tf_knockout_matrix(model, x_f, x_r, bench_bsr, targets.cpu().numpy(), labels)
    log(f"  tf_knockout_matrix over labels {labels} at bench scale (7 two-strand forwards, "
        f"the COO path): {time.perf_counter() - t1:.2f} s; {np.array2string(ko, precision=5)}")
    require(ko.shape == (3, 3) and np.isfinite(ko).all() and not np.diag(ko).any(),
            "tf_knockout_matrix: shape, finite or diagonal")

    # score_snp_table through Expecto at the CLI's defaults, on a synthetic
    # genome: the card in f32 and in float64 against the CPU in float64
    work = tempfile.mkdtemp(prefix="snps_", dir=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "build"))
    try:
        contigs = {c: "".join(rng.choice(list("acgt"), 60_000)) for c in ("chr1", "chr2")}
        write_fasta(os.path.join(work, "genome.fa"), contigs)
        fasta = Fasta(os.path.join(work, "genome.fa"))
        snps = []
        for k in range(SNPS):
            chrom = ("chr1", "chr2")[k % 2]
            pos = int(rng.integers(1_000, 59_000))
            ref = contigs[chrom][pos]
            snps.append((chrom, pos, ref, str(rng.choice([b for b in "acgt" if b != ref]))))
        wstate = create_window_state(make_window_model("expecto", NCLASS, SEQ_LEN, D), "adam",
                                     WINDOW_LR, seed=0, device=cuda)
        t1 = time.perf_counter()
        got32 = score_snp_table(wstate, comp, fasta, snps)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t1
        wstate.model.double()
        got64 = score_snp_table(wstate, comp, fasta, snps)
        wstate.model.cpu()
        t1 = time.perf_counter()
        ref = score_snp_table(wstate, comp.cpu(), fasta, snps)
        t_cpu = time.perf_counter() - t1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    scale = float(np.abs(ref).max())
    err64, err32 = float(np.abs(got64 - ref).max()), float(np.abs(got32 - ref).max())
    log(f"  score_snp_table, {SNPS} SNPs x {NCLASS} labels through Expecto (seq {SEQ_LEN}): "
        f"card f32 {t_card:.2f} s, CPU float64 {t_cpu:.2f} s; scale {scale:.3e}; card float64 "
        f"vs CPU float64 {err64:.3e} ({err64 / scale:.2e} of scale, tol 1e-4); card f32 "
        f"{err32:.3e} ({err32 / scale:.2e} of scale, tol 1e-3: each score is a difference of "
        "two f32 probabilities ~1,000 times its size)")
    require(got32.shape == ref.shape == (SNPS, NCLASS) and np.isfinite(got32).all(),
            "score_snp_table: shape or finite")
    require(err64 <= 1e-4 * scale and err32 <= 1e-3 * scale,
            "score_snp_table: the card disagrees with the CPU")
    log(f"  done in {time.perf_counter() - t0:.1f} s")
    return b1_bench


def parallel_phase(args, smi, graph, flat):
    """Phase 19: the parallel paths at full chr1 scale, in-process on the
    card, and one NCCL rank (see the module doc). ``graph`` and ``flat`` are
    phase 17's world and its flat operator. Returns B1's numbers for the
    kernels line."""
    import torch.distributed as dist

    from chromegcn_tpu_torch.ops import _build
    from chromegcn_tpu_torch.ops.spmm_bsr import bsr_matmul, bsr_matmul_plain, spmm_bsr
    from chromegcn_tpu_torch.parallel.graph import (
        ShardedGraph, attach_shard_bsr, partition_graph, shard_graph, sharded_spmm,
    )
    from chromegcn_tpu_torch.parallel.mesh import init_distributed
    from chromegcn_tpu_torch.train.finetune import chrome_eval_step, chrome_train_step

    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(19)
    x = torch.randn(FULL_PAD, D, device=cuda, generator=gen)
    ct = torch.randn(FULL_PAD, D, device=cuda, generator=gen)
    xg = x.clone().requires_grad_()
    out = spmm_bsr(flat, xg)
    out.backward(ct)
    flat_ax, flat_atg = out.detach(), xg.grad
    del xg, out
    rng = np.random.default_rng(19)
    x_f = torch.from_numpy(rng.normal(size=(FULL_PAD, D)).astype(np.float32)).to(cuda)
    x_r = torch.from_numpy(rng.normal(size=(FULL_PAD, D)).astype(np.float32)).to(cuda)
    targets = torch.from_numpy((rng.random((FULL_PAD, NCLASS)) < 0.1).astype(np.float32)).to(cuda)
    g_flat = graph.replace(bsr=flat)
    errs, launches, event_ms = {}, {}, {}

    for n_shards in (2, 4):
        tag = f"S={n_shards}"
        t0 = time.perf_counter()
        pg = partition_graph(graph, n_shards)
        torch.cuda.synchronize()
        t_part = time.perf_counter() - t0
        t0 = time.perf_counter()
        pg = attach_shard_bsr(pg)
        torch.cuda.synchronize()
        t_attach = time.perf_counter() - t0
        sb, rows = pg.bsr, pg.rows_per_shard
        log(f"[19 parallel {tag}] {smi}; in-process, {n_shards} shards of {rows} rows: host s "
            f"partition_graph {t_part:.2f}, attach_shard_bsr {t_attach:.2f}; halo_widths "
            f"{pg.halo_widths} (halo operator columns {sb.halo_cols})")
        for s in range(n_shards):
            halo_nnz = 0 if sb.halo[s] is None else sb.halo[s].fwd.nnz
            log(f"  shard {s}: local {sb.local[s].fwd.nnz} nonzeros, halo {halo_nnz}")
        send = sum(pg.halo_widths) * D * 4
        log(f"  one rank sends {send / 1e6:.3f} MB a product (sum_k H_k d 4 bytes), against the "
            f"flat x's {FULL_PAD * D * 4 / 1e6:.1f} MB that an all_gather gives every rank")
        require(sum(sb.local[s].fwd.nnz + (0 if sb.halo[s] is None else sb.halo[s].fwd.nnz)
                    for s in range(n_shards)) == flat.fwd.nnz,
                f"{tag}: the shards do not hold the graph's nonzeros")

        # every per-shard B1 launch against its plain version
        mats = {}
        for s in range(n_shards):
            mats[f"shard {s} local fwd"] = (sb.local[s].fwd, x[s * rows:(s + 1) * rows])
            mats[f"shard {s} local bwd"] = (sb.local[s].bwd, ct[s * rows:(s + 1) * rows])
            if sb.halo[s] is not None:
                mats[f"shard {s} halo fwd"] = (sb.halo[s].fwd, x[:sb.halo_cols])
                mats[f"shard {s} halo bwd"] = (sb.halo[s].bwd, ct[s * rows:(s + 1) * rows])
        for name, (m, inp) in mats.items():
            ref = bsr_matmul_plain(m, inp)
            poison_allocator((m.n_rows, D))
            errs[f"{tag} {name}"] = compare(f"B1 {tag} {name} d={D}", bsr_matmul(m, inp), ref)
            del ref

        # the product and its gradient against the flat ones, with launches
        per_product = sum(1 + (sb.halo[s] is not None) for s in range(n_shards))
        xg = x.clone().requires_grad_()
        _build.LAUNCHES.clear()
        out = sharded_spmm(pg, xg, strategy="halo_bsr")
        torch.cuda.synchronize()
        n_fwd = _build.LAUNCHES["bsr_spmm"]
        _build.LAUNCHES.clear()
        out.backward(ct)
        torch.cuda.synchronize()
        n_bwd = _build.LAUNCHES["bsr_spmm"]
        log(f"  B1 launches: {n_fwd} for A x, {n_bwd} for A^T g (2 a shard, 1 where its halo "
            f"is empty: {per_product})")
        require(n_fwd == n_bwd == per_product, f"{tag}: expected {per_product} B1 launches a product")
        errs[f"{tag} A x"] = compare(f"{tag} sharded A x vs flat", out.detach(), flat_ax)
        errs[f"{tag} A^T g"] = compare(f"{tag} sharded A^T g vs flat", xg.grad, flat_atg)
        del xg, out

        # the unfused train step on the sharded graph against the flat one
        sg = ShardedGraph(pg=pg, node_mask=graph.node_mask, strategy="halo_bsr",
                          n_nodes=graph.n_nodes)
        state_s, state_f = new_state(0.0, "pallas"), new_state(0.0, "pallas")
        require(not state_s.model._use_fused(x_f, sg), "the fused model fuses on a sharded graph")
        _build.LAUNCHES.clear()
        _, loss_s, _ = chrome_train_step(state_s, x_f, x_r, sg, targets)
        torch.cuda.synchronize()
        launches[tag] = gcn_launches()
        _, loss_f, _ = chrome_train_step(state_f, x_f, x_r, g_flat, targets)
        rel = abs(loss_s.item() - loss_f.item()) / abs(loss_f.item())
        log(f"  train step, dropout 0, same weights: loss sharded {loss_s.item():.8f} flat "
            f"{loss_f.item():.8f} rel diff {rel:.2e} (tol 1e-5); launches {launches[tag]} "
            f"(8 products' {per_product} each)")
        require(rel <= 1e-5, f"{tag}: sharded and flat train-step losses disagree")
        require(launches[tag] == {"bsr_spmm": 8 * per_product},
                f"{tag}: expected {8 * per_product} B1 launches per train step, and no B2 or B3")
        check_grads(state_s, state_f)
        del state_f

        # times: the product against the flat one, each shard's launches
        # against their bounds (CUDA events), the steps on the host clock
        fns = {"sharded": lambda: sharded_spmm(pg, x, strategy="halo_bsr"),
               "flat": lambda: bsr_matmul(flat.fwd, x)}
        for name, (m, inp) in mats.items():
            if name.endswith("fwd"):
                fns[name] = lambda m=m, inp=inp: bsr_matmul(m, inp)
        with torch.no_grad():
            t = cuda_ms(fns)
        med = {k: statistics.median(v) for k, v in t.items()}
        event_ms[tag] = med["sharded"]
        b_ms, b_by, _, _ = bound(flat.fwd, D)
        log(f"  A x at d {D}, ms (CUDA events, median (min-max) of 5 loops of 20 in turns): "
            f"sharded {spread(t['sharded'])} ({per_product} B1 launches), flat "
            f"{spread(t['flat'])} ({100 * b_ms / med['flat']:.1f}% of the flat bound "
            f"{b_ms:.4f} ms by {b_by}; its longest row {int(flat.fwd.row_ptr.diff().max())})")
        for name, (m, _) in mats.items():
            if name.endswith("fwd"):
                bm, by, nbytes, _ = bound(m, D)
                lengths = m.row_ptr.diff()
                log(f"    {name}: {spread(t[name])} ms, its bound {bm:.4f} ms by {by} "
                    f"({nbytes / 1e6:.1f} MB, x {m.n_cols * D * 4 / 1e6:.1f} MB): "
                    f"{100 * bm / med[name]:.1f}%; {int((lengths > 0).sum())} rows with "
                    f"entries, the longest {int(lengths.max())}")
        state_e = new_state(0.0, "pallas")
        gen_step = torch.Generator(device=cuda).manual_seed(0)
        peaks = {}
        for kind, step in (("train", lambda: chrome_train_step(state_s, x_f, x_r, sg, targets,
                                                               gen_step)),
                           ("eval", lambda: chrome_eval_step(state_e, x_f, x_r, sg, targets))):
            step()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step()
            torch.cuda.synchronize()
            peaks[kind] = (torch.cuda.max_memory_allocated() - held) / 2**30
        steps = host_ms({
            "sharded train": lambda: chrome_train_step(state_s, x_f, x_r, sg, targets, gen_step),
            "sharded eval": lambda: chrome_eval_step(state_e, x_f, x_r, sg, targets),
            "flat train": lambda: chrome_train_step(state_e, x_f, x_r, g_flat, targets, gen_step),
            "flat eval": lambda: chrome_eval_step(state_e, x_f, x_r, g_flat, targets)},
            iters=3, repeats=3, warmup=1)
        log(f"  host ms per step, median (min-max) of 3 loops of 3 in turns: sharded train "
            f"{spread(steps['sharded train'])}, eval {spread(steps['sharded eval'])}; flat train "
            f"{spread(steps['flat train'])}, eval {spread(steps['flat eval'])}; peak device "
            f"memory above what the process held, sharded: {peaks['train']:.2f} GiB (train), "
            f"{peaks['eval']:.2f} GiB (eval)")
        del state_s, state_e, sg, pg, sb, mats, fns

    # one NCCL rank: the distributed mode's all-reduces run on the card
    store = tempfile.mkdtemp(prefix="nccl_", dir=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "build"))
    try:
        require(init_distributed("cuda", init_method=f"file://{os.path.join(store, 'store')}",
                                 world_size=1, rank=0), "no process group")
        require(dist.get_backend() == "nccl", f"the group runs {dist.get_backend()}, not nccl")
        sg1 = shard_graph(graph, 1, strategy="halo_bsr", group=dist.group.WORLD)
        state_n, state_f = new_state(0.0, "pallas"), new_state(0.0, "pallas")
        _build.LAUNCHES.clear()
        _, loss_n, probs_n = chrome_train_step(state_n, x_f, x_r, sg1, targets)
        torch.cuda.synchronize()
        launches["nccl"] = gcn_launches()
        _, loss_f, probs_f = chrome_train_step(state_f, x_f, x_r, g_flat, targets)
        rel = abs(loss_n.item() - loss_f.item()) / abs(loss_f.item())
        log(f"[19 parallel, one NCCL rank] {smi}; distributed mode over a 1-rank nccl group "
            f"(BatchNorm statistics, loss and gradients all-reduced on the card): loss "
            f"{loss_n.item():.8f} vs the plain step's {loss_f.item():.8f}, rel diff {rel:.2e} "
            f"(tol 1e-5); launches {launches['nccl']}")
        require(rel <= 1e-5, "the one-rank NCCL step and the plain step disagree")
        require(launches["nccl"] == {"bsr_spmm": 8}, "expected 8 B1 launches in the NCCL step")
        errs["nccl probs"] = compare("NCCL step probs vs plain", probs_n, probs_f)
        check_grads(state_n, state_f)
        eval_n = chrome_eval_step(state_n, x_f, x_r, sg1, targets)[0].item()
        eval_f = chrome_eval_step(state_f, x_f, x_r, g_flat, targets)[0].item()
        require(abs(eval_n - eval_f) <= 1e-5 * abs(eval_f), "the NCCL eval step disagrees")
        del state_n, state_f, sg1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return {"max_abs_err_sharded": max(errs.values()),
            "launches_sharded_train_step": launches["S=4"]["bsr_spmm"],
            "launches_nccl_train_step": launches["nccl"]["bsr_spmm"],
            "event_ms_sharded": event_ms}


def ingest_phase(args, smi, here):
    """Phase 16: the host ingest at full chr1, then its graph on the card and
    the raw-files-to-finetune chain through the CLIs (see the module doc).
    Returns B1's numbers for the kernels line."""
    from chromegcn_tpu_torch import native_bridge
    from chromegcn_tpu_torch.data import artifact
    from chromegcn_tpu_torch.data.loader import load_chrom_features
    from chromegcn_tpu_torch.data.synthetic_raw import make_raw_world
    from chromegcn_tpu_torch.main import main as cli_main
    from chromegcn_tpu_torch.ops import _build
    from chromegcn_tpu_torch.ops.sparse import build_chrom_graph
    from chromegcn_tpu_torch.ops.spmm_bsr import attach_bsr, bsr_matmul, bsr_matmul_plain
    from chromegcn_tpu_torch.pipeline import build as pipeline_build
    from chromegcn_tpu_torch.pipeline.__main__ import main as pipeline_main
    from chromegcn_tpu_torch.pipeline.genome import HG19_SIZES, tile_windows
    from chromegcn_tpu_torch.pipeline.hic import read_norm_vector, split_graph_paths
    from chromegcn_tpu_torch.pipeline.peaks import collect_peak_files, read_narrowpeak
    from chromegcn_tpu_torch.train.finetune import (
        bucket_nodes, chrome_eval_step, chrome_train_step,
    )
    from chromegcn_tpu_torch.train.runner import build_split_graphs

    cuda = torch.device("cuda")
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="ingest_", dir=os.path.join(here, "build"))
    try:
        # (a) the raw files of hg19's chr1
        raw = os.path.join(work, "raw")
        size = HG19_SIZES["chr1"]
        t0 = time.perf_counter()
        truth = make_raw_world(raw, {"chr1": size}, seed=INGEST_SEED, verbose=lambda *_: None)
        t_gen = time.perf_counter() - t0
        chr1 = truth["chroms"]["chr1"]
        raw_path = os.path.join(raw, "hic", "chr1.RAWobserved")
        norm_path = os.path.join(raw, "hic", "chr1.SQRTVCnorm")
        with open(raw_path, "rb") as f:
            n_lines = sum(chunk.count(b"\n") for chunk in iter(lambda: f.read(1 << 24), b""))
        mb = {name: os.path.getsize(os.path.join(raw, rel)) / 1e6 for name, rel in (
            ("genome.fa", "genome.fa"), ("RAWobserved", "hic/chr1.RAWobserved"),
            ("SQRTVCnorm", "hic/chr1.SQRTVCnorm"))}
        mb["peaks"] = sum(os.path.getsize(p) for p in collect_peak_files(
            os.path.join(raw, "peaks"))) / 1e6
        log(f"[16 ingest] {smi}; make_raw_world over hg19 chr1 ({size} bp, "
            f"{truth['n_assays']} assays, seed {INGEST_SEED}): {t_gen:.1f} s host; "
            f"{chr1['n_windows']} windows, {chr1['kept_windows']} with a peak, "
            f"{chr1['positives']} positive labels; files "
            + ", ".join(f"{k} {v:.1f} MB" for k, v in mb.items())
            + f"; RAWobserved {n_lines} lines ({chr1['signal_pairs']} signal + "
            f"{chr1['noise_pairs']} noise contacts)")
        require(n_lines == chr1["signal_pairs"] + chr1["noise_pairs"],
                "the RAWobserved file's line count differs from the world's contacts")

        # (b) the pipeline CLI, its two stages timed apart
        out = os.path.join(work, "SYNRAW", "1000")
        argv = ["--fasta", os.path.join(raw, "genome.fa"), "--peaks", os.path.join(raw, "peaks"),
                "--hic", os.path.join(raw, "hic"), "--out", out,
                "--hicsize", str(INGEST_HICSIZE), "--hicnorm", "SQRTVC"]
        secs = {}
        with timed(pipeline_build, ("build_dataset", "build_hic_graphs"), secs), \
                timed(native_bridge, ("hic_topk",), secs):
            printed, t_cli = run_cli(pipeline_main, argv)
        log(f"  python -m chromegcn_tpu_torch.pipeline --hicsize {INGEST_HICSIZE} --hicnorm "
            f"SQRTVC: {t_cli:.1f} s host; build_dataset {secs['build_dataset']:.1f} s, "
            f"build_hic_graphs {secs['build_hic_graphs']:.1f} s (hic_topk "
            f"{secs['hic_topk']:.2f} s, {n_lines / secs['hic_topk'] / 1e6:.2f} M lines/s)")
        for line in printed:
            log(f"    {line}")
        data = np.load(os.path.join(out, "dataset.npz"), allow_pickle=False)
        require(sorted(data.files) == ["meta", "test/chroms", "test/starts", "test/targets",
                                       "test/tokens"], f"dataset.npz holds {data.files}")
        starts, targets = data["test/starts"], data["test/targets"]
        tokens = data["test/tokens"]
        kept = len(starts)
        log(f"  dataset.npz: {kept} windows x {tokens.shape[1]} tokens, {targets.shape[1]} "
            f"labels, {int(targets.sum())} positive; ground truth {chr1['kept_windows']} windows, "
            f"{chr1['positives']} positive")
        require(kept == chr1["kept_windows"], "the ingest kept other windows than the truth's")
        require(int(targets.sum()) == chr1["positives"], "the ingest's labels differ in count")
        require(tokens.shape == (kept, 2000) and int(tokens.min()) >= 0
                and int(tokens.max()) <= 4, "tokens of a wrong shape or out of the vocabulary")
        require(bool((np.diff(starts) > 0).all()) and bool((starts % 1000 == 0).all()),
                "window starts out of order or off the 1 kb grid")
        del tokens, data
        graph_path = split_graph_paths(os.path.join(out, "hic"), "test", str(INGEST_HICSIZE),
                                       "SQRTVC")
        s, r, v = artifact.load_graph_edges(graph_path)["chr1"]
        pairs = set(zip(s.tolist(), r.tolist()))
        require(len(s) > 0 and all((b, a) in pairs for a, b in pairs),
                "the ingested graph is not symmetric")
        require(int(max(s.max(), r.max())) < kept and int(min(s.min(), r.min())) >= 0
                and not bool((s == r).any()), "an edge leaves the kept windows or is a loop")

        # the plain versions against the library
        norm = read_norm_vector(norm_path)
        k = INGEST_HICSIZE // 2
        t0 = time.perf_counter()
        nat = native_bridge.hic_topk(raw_path, starts, k, norm=norm)
        t_nat = time.perf_counter() - t0
        nxt = native_bridge.hic_topk(raw_path, starts, k + 1, norm=norm)
        tie = len(nxt[2]) > k and nxt[2][k] == nat[2][-1]
        t0 = time.perf_counter()
        plain = native_bridge.hic_topk_plain(raw_path, starts, k, norm=norm)
        t_plain = time.perf_counter() - t0
        n = len(nat[0])
        require(np.array_equal(np.searchsorted(starts, nat[0]), s[:n])
                and np.array_equal(np.searchsorted(starts, nat[1]), r[:n]),
                "the graph file's edges are not hic_topk's contacts")
        ok = same_topk(nat, plain, tie)
        log(f"  hic_topk over the whole file, k {k}: {n} contacts kept, the library "
            f"{t_nat:.2f} s ({n_lines / t_nat / 1e6:.2f} M lines/s), plain (numpy) {t_plain:.2f} s; "
            f"a tie at the k-th value: {tie}; plain = library as sets with equal values: "
            f"{'ok' if ok else 'MISMATCH'}")
        require(ok, "hic_topk_plain disagrees with the library")
        del nat, nxt, plain
        ws, we = tile_windows(size)
        ws, we = ws[:INGEST_INTERSECT_WINDOWS], we[:INGEST_INTERSECT_WINDOWS]
        n_pairs, t_nat, t_plain = 0, 0.0, 0.0
        for path in collect_peak_files(os.path.join(raw, "peaks")):
            ps = read_narrowpeak(path)
            sel = ps["chrom"] == "chr1"
            t0 = time.perf_counter()
            got = native_bridge.intersect_fraction(ws, we, ps["start"][sel], ps["end"][sel], 0.1)
            t1 = time.perf_counter()
            ref = native_bridge.intersect_fraction_plain(ws, we, ps["start"][sel],
                                                         ps["end"][sel], 0.1)
            t_nat, t_plain = t_nat + t1 - t0, t_plain + time.perf_counter() - t1
            require(sorted(zip(got[0].tolist(), got[1].tolist()))
                    == sorted(zip(ref[0].tolist(), ref[1].tolist())),
                    f"intersect_fraction_plain disagrees with the library on {path}")
            n_pairs += len(got[0])
        log(f"  intersect_fraction, the first {INGEST_INTERSECT_WINDOWS} windows x each of "
            f"{truth['n_assays']} assays: {n_pairs} pairs, the library {t_nat:.3f} s, plain "
            f"{t_plain:.2f} s; plain = library (sorted pairs): ok")

        # (c) the ingested graph on the card: B1, and the full-width step
        n_pad = bucket_nodes(kept)
        t0 = time.perf_counter()
        graph = build_chrom_graph("hic", n_valid=kept, n_pad=n_pad, hic_edges=(s, r, v),
                                  device=cuda)
        g = attach_bsr(graph, device=cuda)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        op = g.bsr
        rows = {k_: op_.row_ptr.diff() for k_, op_ in (("fwd", op.fwd), ("bwd", op.bwd))}
        longest = {k_: int(v_.max()) for k_, v_ in rows.items()}
        log(f"  on the card: build_chrom_graph + attach_bsr {t_build:.1f} s host; N_PAD {n_pad}, "
            f"{graph.n_edges} edges, {op.fwd.nnz} nonzeros a direction; longest row "
            f"{longest['fwd']} (fwd) / {longest['bwd']} (bwd), mean "
            f"{op.fwd.nnz / kept:.2f} a kept window, {int((rows['fwd'][:kept] == 0).sum())} "
            f"kept windows without an edge")
        for direction in ("fwd", "bwd"):
            check_csr_matches_blocks(f"ingested chr1 {direction}", getattr(op, direction))
        gen = torch.Generator(device=cuda).manual_seed(INGEST_SEED)
        x = torch.randn(n_pad, D, device=cuda, generator=gen)
        errs = {}
        for direction, what in (("fwd", "A x"), ("bwd", "A^T g")):
            m = getattr(op, direction)
            ref = bsr_matmul_plain(m, x)
            poison_allocator((n_pad, D))
            errs[direction] = compare(f"B1 {what} over the ingested chr1 graph d={D}",
                                      bsr_matmul(m, x), ref)
        del ref
        rng = np.random.default_rng(INGEST_SEED)
        x_f = torch.from_numpy(rng.normal(size=(n_pad, D)).astype(np.float32)).to(cuda)
        x_r = torch.from_numpy(rng.normal(size=(n_pad, D)).astype(np.float32)).to(cuda)
        tgt = torch.from_numpy((rng.random((n_pad, NCLASS)) < 0.1).astype(np.float32)).to(cuda)
        state = new_state(0.2, "auto")
        gen_step = torch.Generator(device=cuda).manual_seed(0)
        steps = {"train": lambda: chrome_train_step(state, x_f, x_r, g, tgt, gen_step),
                 "eval": lambda: chrome_eval_step(state, x_f, x_r, g, tgt)}
        counts, peaks = {}, {}
        for kind, step in steps.items():
            step()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _build.LAUNCHES.clear()
            res = step()
            torch.cuda.synchronize()
            counts[kind] = gcn_launches()
            peaks[kind] = (torch.cuda.max_memory_allocated() - held) / 2**30
            require(all(bool(torch.isfinite(t).all()) for t in res[-2:]),
                    f"ingested chr1 {kind} step: non-finite loss or probs")
            del res
        t_steps = host_ms(steps)
        edges_per_step = graph.n_edges * LAYERS * 2 * 2
        log(f"  full-width GCN (d {D}, {NCLASS} classes, {LAYERS} layers, 2 strands, SGD lr "
            f"{LR}, dropout 0.2, random features from seed {INGEST_SEED}): host ms per step, "
            f"median (min-max) of 5 loops of 5 in turns: train {spread(t_steps['train'])} = "
            f"{edges_per_step / statistics.median(t_steps['train']) / 1e3:.1f} M edges/s, eval "
            f"{spread(t_steps['eval'])}; peak device memory above what the process held "
            f"{peaks['train']:.2f} GiB (train), {peaks['eval']:.2f} GiB (eval); launches "
            f"{counts['train']} (train), {counts['eval']} (eval)")
        require(counts == {"train": {"bsr_spmm": 8}, "eval": {"bsr_spmm": 4}},
                "expected 8 B1 launches per train step and 4 per eval step")
        del state
        adj_csr = csr_of(graph)
        t = cuda_ms({"fwd": lambda: bsr_matmul(op.fwd, x), "bwd": lambda: bsr_matmul(op.bwd, x),
                     "plain": lambda: bsr_matmul_plain(op.fwd, x),
                     "library": lambda: torch.sparse.mm(adj_csr, x)})
        b_ms, b_by, b_bytes, _ = bound(op.fwd, D)
        ev = statistics.median(t["fwd"])
        log(f"  B1 ms per product over the ingested graph, d {D} (CUDA events, median (min-max) "
            f"of 5 loops of 20 in turns): fwd {spread(t['fwd'])}, bwd {spread(t['bwd'])}, "
            f"plain {spread(t['plain'])}, torch.sparse.mm CSR {spread(t['library'])}; bound "
            f"{b_ms:.4f} ms by {b_by} ({b_bytes / 1e6:.1f} MB): B1 at {100 * b_ms / ev:.1f}%, "
            f"{1e3 * ev / longest['fwd']:.3f} us per entry of the longest row")
        require(b_ms / ev <= 1.0, "B1 above 100% of its bound")
        del x, x_f, x_r, tgt, adj_csr, g, graph, op
        torch.cuda.empty_cache()

        # (d) raw files -> pipeline CLI -> pretrain -> save_feats -> finetune
        chain_raw = os.path.join(work, "chain_raw")
        chain_data = os.path.join(work, "chain")
        t0 = time.perf_counter()
        chain_truth = make_raw_world(chain_raw, INGEST_CHAIN_SIZES, seed=INGEST_SEED + 1,
                                     verbose=lambda *_: None)
        _, t_pipe = run_cli(pipeline_main, [
            "--fasta", os.path.join(chain_raw, "genome.fa"),
            "--peaks", os.path.join(chain_raw, "peaks"), "--hic", os.path.join(chain_raw, "hic"),
            "--out", os.path.join(chain_data, "SYNRAW", "1000"),
            "--hicsize", str(INGEST_HICSIZE), "--hicnorm", "SQRTVC"])
        log(f"  the chain: make_raw_world {INGEST_CHAIN_SIZES} bp (seed {INGEST_SEED + 1}) "
            f"{time.perf_counter() - t0 - t_pipe:.1f} s, the pipeline CLI {t_pipe:.1f} s; "
            + ", ".join(f"{c} {v['kept_windows']} windows" for c, v in
                        chain_truth["chroms"].items())
            + f"; {chain_truth['n_assays']} labels (cut from {NCLASS}: make_raw_world plants "
            "one motif per assay)")
        base = ["-dataroot", chain_data, "-results_dir", os.path.join(work, "results"),
                "-cell_type", "SYNRAW", "-seq_length", str(SEQ_LEN), "-batch_size",
                str(WINDOW_BATCH), "-adj_type", "hic", "-hicsize", str(INGEST_HICSIZE),
                "-hicnorm", "SQRTVC", "-window_model", "expecto", "-d_model", str(D)]
        chain_counts = {}
        for mode, extra in (("pretrain", ["-pretrain", "-epochs", "1"]),
                            ("save_feats", ["-save_feats"]),
                            ("finetune", ["-load_pretrained", "-epochs", "1"])):
            _build.LAUNCHES.clear()
            out_lines, secs_mode = run_cli(cli_main, base + extra)
            chain_counts[mode] = gcn_launches()
            cfg = cli_config(base + extra)
            if mode == "save_feats":
                for split, chroms in (("train", ["chr2", "chr4"]), ("valid", ["chr3"]),
                                      ("test", ["chr1"])):
                    feats = load_chrom_features(cfg.feature_path(split))
                    require(sorted(feats) == chroms, f"{split}: features of {sorted(feats)}")
                    for chrom, cf in feats.items():
                        n_c = chain_truth["chroms"][chrom]["kept_windows"]
                        require(cf.forward.shape == cf.backward.shape == (n_c, D)
                                and cf.target.shape == (n_c, chain_truth["n_assays"])
                                and np.isfinite(cf.forward).all()
                                and np.isfinite(cf.backward).all(),
                                f"{split} {chrom}: features of a wrong shape or non-finite")
                log(f"  expecto {' '.join(extra)}: {secs_mode:.1f} s; launches "
                    f"{chain_counts[mode]}; every split's features ({D} columns a strand)")
                continue
            logs = read_logs(cfg.stage1_run_dir if mode == "pretrain" else cfg.run_dir)
            log(f"  expecto {' '.join(extra)}: {secs_mode:.1f} s; launches {chain_counts[mode]}; "
                + "; ".join(f"{sp} loss {logs[sp][0][1]:.6f} meanAUC {logs[sp][0][3]:.4f}"
                            for sp in ("train", "valid", "test")))
            require(all(len(rows_) == 1 and np.isfinite(rows_[0][1]) for rows_ in logs.values()),
                    f"{mode}: a wrong epoch count or a non-finite loss")
            if mode == "finetune":
                require(any("warm-started GCN head from CNN checkpoint" in l for l in out_lines),
                        "the chain's finetune did not log its warm start")
        per_product = {}
        for split in ("train", "valid", "test"):
            graphs = build_split_graphs(cfg, load_chrom_features(cfg.feature_path(split)), split,
                                        device=cuda, verbose=lambda *_: None)
            per_product[split] = [launches_per_product(gr.bsr) for gr in graphs.values()]
        want_b1 = 8 * sum(per_product["train"]) + 4 * sum(per_product["valid"]
                                                          + per_product["test"])
        log(f"  the finetune epoch's B1 launches {chain_counts['finetune']} (B1 launches per "
            f"product, by chromosome: {per_product})")
        require(chain_counts["finetune"] == {"bsr_spmm": want_b1},
                f"expected {want_b1} B1 launches and no B2 or B3 in the chain's finetune")
        require(not chain_counts["pretrain"] and not chain_counts["save_feats"],
                "the window stage launched a GCN kernel")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"  done in {time.perf_counter() - t_phase:.1f} s")
    return {"launches_ingest_train_step": counts["train"]["bsr_spmm"],
            "launches_ingest_cli_epoch": chain_counts["finetune"]["bsr_spmm"],
            "event_ms_ingest": ev, "bound_ms_ingest": b_ms,
            "max_abs_err_ingest": max(errs.values())}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also trace 3 train steps with torch.profiler")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs a CUDA card",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "chromegcn_tpu_torch")):
        print(f"chip_smoke: no chromegcn_tpu_torch package beside {__file__}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    from chromegcn_tpu_torch.data.synthetic import make_hic_edges
    from chromegcn_tpu_torch.main import main as cli_main
    from chromegcn_tpu_torch.ops import _build
    from chromegcn_tpu_torch.ops import gcn_fused
    from chromegcn_tpu_torch.ops.gcn_fused import (
        fused_bwd, fused_bwd_plain, fused_fwd, fused_fwd_plain, fused_gated_layer,
    )
    from chromegcn_tpu_torch.ops.sparse import build_chrom_graph, from_dense, to_dense
    from chromegcn_tpu_torch.ops.spmm_bsr import (
        attach_bsr, bsr_from_graph, bsr_matmul, bsr_matmul_plain, spmm_bsr,
        streamed_elements,
    )
    from chromegcn_tpu_torch.train.finetune import chrome_eval_step, chrome_train_step

    t_start = time.perf_counter()
    cuda = torch.device("cuda")
    # f32-faithful: no TF32 in matmuls or cuDNN (the reference runs HIGHEST)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card ----
    smi = nvidia_smi_line()
    log(f"[1 card] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 2. build: one nvcc per source, started together ----
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        build_logs = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    status = ", ".join(f"{k} {'built' if v is not None else 'already built'}"
                       for k, v in build_logs.items())
    log(f"[2 build] {status} in {time.perf_counter() - t0:.1f} s")
    for name, build_log in build_logs.items():
        for line in (build_log or "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {name}: {line.strip()}")
    # B2's and B3's plans are the ones fused_fits and the wrappers read, and
    # both fit at every width fused_fits admits (it reads no tiles, so any
    # operator will do)
    fwd_lib, bwd_lib = gcn_fused._kernel_lib(), gcn_fused._bwd_kernel_lib()
    tiny = bsr_from_graph(from_dense(np.eye(128), device=cuda), device=cuda)
    admitted = [d for d in range(4, 4097, 4) if gcn_fused.fused_fits(tiny, d)]
    widest = admitted[-1]
    require(admitted == list(range(4, widest + 1, 4)), "fused_fits admits a ragged set of widths")
    for d in range(4, 4097, 4):
        plans = (fwd_lib.gcn_fused_smem_bytes(d), bwd_lib.gcn_fused_bwd_smem_bytes(d))
        require(plans == (gcn_fused.fwd_smem_bytes(d), gcn_fused.bwd_smem_bytes(d)),
                f"a fused kernel's shared-memory plan differs from the Python one at d {d}")
        require(d > widest or max(plans) <= gcn_fused.SMEM_LIMIT,
                f"a plan at admitted d {d} does not fit: {plans} bytes")
    log(f"  B2/B3 plans equal the Python ones at d 4-4096 and fit at every width "
        f"fused_fits admits (d <= {widest}): {gcn_fused.fwd_smem_bytes(D)} and "
        f"{gcn_fused.bwd_smem_bytes(D)} bytes at d {D}, {gcn_fused.fwd_smem_bytes(widest)} "
        f"and {gcn_fused.bwd_smem_bytes(widest)} at d {widest}")

    gen = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=cuda, generator=gen)

    # ---- 3. B1 against its plain version ----
    t0 = time.perf_counter()
    s, r, v = make_hic_edges(N_VALID, N_PAIRS, seed=0)
    graph = build_chrom_graph("hic", n_valid=N_VALID, n_pad=N_PAD, hic_edges=(s, r, v),
                              device=cuda)
    hub_graph = build_chrom_graph(
        "hic", n_valid=N_VALID, n_pad=N_PAD, device=cuda,
        hic_edges=make_hic_edges(N_VALID, N_PAIRS, seed=0, hubness=0.5))
    ops = {
        "f32": bsr_from_graph(graph, device=cuda),
        "bf16": bsr_from_graph(graph, dtype="bfloat16", device=cuda),
        "tile256_min8": bsr_from_graph(graph, tile=256, min_edges_per_tile=8, device=cuda),
        "all_strips": bsr_from_graph(graph, min_edges_per_tile=10**9, device=cuda),
        "hub": bsr_from_graph(hub_graph, device=cuda),
    }
    op = ops["f32"]
    acct = streamed_elements(op, d=D)["fwd"]
    elems, block_bytes = block_form(op.fwd)
    row_nnz = op.fwd.row_ptr.diff()
    log(f"[3 B1 vs plain] bench graph: {graph.n_edges} edges, N_PAD {graph.n_nodes}; "
        f"fwd nt {op.fwd.nt} ns {op.fwd.ns}, bwd nt {op.bwd.nt} ns {op.bwd.ns}; "
        f"streamed block elements {acct['block_elems']} per direction; "
        f"{op.fwd.nnz} nonzeros per direction, {int(row_nnz.max())} at most in a row, "
        f"{int((row_nnz == 0).sum())} empty rows; hub graph {hub_graph.n_edges} edges, "
        f"{int(ops['hub'].fwd.row_ptr.diff().max())} at most in a row; "
        f"built in {time.perf_counter() - t0:.1f} s")
    log(f"  block form (a record of the operand's size, not the bound): {elems} live "
        f"block elements, {block_bytes / 1e6:.1f} MB with their indices, per direction")
    for key, o in ops.items():
        for direction in ("fwd", "bwd"):
            check_csr_matches_blocks(f"{key} {direction}", getattr(o, direction))
    errs = {}
    for key, o in ops.items():
        for direction in ("fwd", "bwd"):
            m = getattr(o, direction)
            for d in ((D, 2 * D) if key in ("f32", "bf16") else (D,)):
                x = randn(m.n_cols, d)
                ref = bsr_matmul_plain(m, x)
                poison_allocator((m.n_rows, d))
                errs[f"{key}.{direction}.d{d}"] = compare(
                    f"{key} {direction} d={d}", bsr_matmul(m, x), ref)
    # small graphs, every tile height the kernel is built for, against a
    # dense float64 product: rows with no blocks must come out zero
    for tile in (32, 64, 128, 256):
        rng = np.random.default_rng(tile)
        dense = (rng.random((1024, 1024)) < 0.01) * rng.random((1024, 1024))
        dense[512:640] = 0.0
        g = from_dense(dense, device=cuda)
        m = bsr_from_graph(g, tile=tile, min_edges_per_tile=4, device=cuda).fwd
        x = randn(1024, 96)
        ref = (to_dense(g).double() @ x.double()).float()
        poison_allocator((1024, 96))
        errs[f"dense.tile{tile}"] = compare(f"dense 1024 tile={tile} d=96", bsr_matmul(m, x), ref)
    # one row of ~1,500 entries (~47 batches of 32 in the kernel's gather);
    # atol of scale: f32 sums of 1,500 products against float64
    rng = np.random.default_rng(1)
    dense = (rng.random((2048, 2048)) < 0.01) * rng.random((2048, 2048))
    dense[77, rng.choice(2048, 1500, replace=False)] = rng.random(1500) + 0.1
    dense[1024:1152] = 0.0
    g = from_dense(dense, device=cuda)
    m = bsr_from_graph(g, min_edges_per_tile=4, device=cuda).fwd
    require(int(m.row_ptr.diff().max()) >= 1000, "the long-row graph lost its long row")
    check_csr_matches_blocks("long-row graph fwd", m)
    x = randn(2048, D)
    ref = (to_dense(g).double() @ x.double()).float()
    poison_allocator((2048, D))
    errs["long_row"] = compare(f"dense 2048, a row of {int(m.row_ptr.diff().max())} entries, "
                               f"d={D} vs float64 (atol of scale)", bsr_matmul(m, x), ref,
                               scaled=True)
    # widths that are not a multiple of 4: x's rows are then 8-byte (d % 4
    # == 2, float2 loads) or 4-byte (odd d, scalar loads) aligned
    odd_widths = (1850, 925, 6, 1)
    for d in odd_widths:
        for key in ("f32", "bf16"):
            m = ops[key].fwd
            x = randn(m.n_cols, d)
            ref = bsr_matmul_plain(m, x)
            poison_allocator((m.n_rows, d))
            errs[f"{key}.fwd.d{d}"] = compare(f"{key} fwd d={d}", bsr_matmul(m, x), ref)
            del x, ref
        rng = np.random.default_rng(d)
        dense = (rng.random((1024, 1024)) < 0.01) * rng.random((1024, 1024))
        dense[512:640] = 0.0
        g = from_dense(dense, device=cuda)
        x = randn(1024, d)
        for key in ("float32", "bfloat16"):
            m = bsr_from_graph(g, min_edges_per_tile=4, dtype=key, device=cuda).fwd
            # the bf16 kernel multiplies bf16 values by x rounded to bf16
            a64, x64 = to_dense(g).double(), x.double()
            if key == "bfloat16":
                a64, x64 = a64.bfloat16().double(), x.bfloat16().double()
            poison_allocator((1024, d))
            errs[f"dense.{key}.d{d}"] = compare(
                f"dense 1024 {key} d={d} vs float64 (atol of scale)", bsr_matmul(m, x),
                (a64 @ x64).float(), scaled=True)
    torch.cuda.synchronize()

    # ---- 4. SpmmBSR gradient ----
    x = randn(N_PAD, D).requires_grad_()
    ct = randn(N_PAD, D)
    (spmm_bsr(op, x) * ct).sum().backward()
    xp = x.detach().clone().requires_grad_()
    (bsr_matmul_plain(op.fwd, xp) * ct).sum().backward()
    log("[4 SpmmBSR grad]")
    errs["grad"] = compare("dL/dx kernel (A^T over op.bwd) vs plain autograd", x.grad, xp.grad)

    # ---- 5. the main path at full width ----
    graph_bsr = attach_bsr(graph, device=cuda)
    rng = np.random.default_rng(0)
    x_f = torch.from_numpy(rng.normal(size=(N_PAD, D)).astype(np.float32)).to(cuda)
    x_r = torch.from_numpy(rng.normal(size=(N_PAD, D)).astype(np.float32)).to(cuda)
    targets = torch.from_numpy((rng.random((N_PAD, NCLASS)) < 0.1).astype(np.float32)).to(cuda)

    log("[5 main path] kernel-path step vs plain COO-path step, dropout 0, same weights")
    state_k, state_p = new_state(0.0, "pallas"), new_state(0.0, "xla")
    _, loss_k, probs_k = chrome_train_step(state_k, x_f, x_r, graph_bsr, targets)
    _, loss_p, probs_p = chrome_train_step(state_p, x_f, x_r, graph_bsr, targets)
    rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    log(f"  loss kernel {loss_k.item():.8f} plain {loss_p.item():.8f} rel diff {rel:.2e} (tol 1e-5)")
    require(rel <= 1e-5, "train-step losses disagree")
    check_grads(state_k, state_p)
    del state_k, state_p, probs_k, probs_p

    state = new_state(0.2, "auto")
    gen_step = torch.Generator(device=cuda).manual_seed(0)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    losses = []
    for _ in range(TRAIN_STEPS):
        _, loss, probs = chrome_train_step(state, x_f, x_r, graph_bsr, targets, gen_step)
        losses.append(loss)
    torch.cuda.synchronize()
    train_launches = _build.LAUNCHES["bsr_spmm"]
    eval_loss, eval_probs = chrome_eval_step(state, x_f, x_r, graph_bsr, targets)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    eval_launches = launches["bsr_spmm"] - train_launches
    losses = [l.item() for l in losses]
    log(f"  {TRAIN_STEPS} train steps (dropout 0.2) losses {['%.6f' % l for l in losses]}; "
        f"eval loss {eval_loss.item():.6f}")
    log(f"  launches: bsr_spmm {train_launches} in {TRAIN_STEPS} train steps "
        f"({train_launches / TRAIN_STEPS:g} per step), {eval_launches} in 1 eval step")
    require(all(np.isfinite(losses)) and np.isfinite(eval_loss.item()), "non-finite loss")
    require(probs.shape == eval_probs.shape == (N_PAD, NCLASS), "probs shape")
    require(bool(torch.isfinite(eval_probs).all()), "non-finite probs")
    require(train_launches == 8 * TRAIN_STEPS, "expected 8 B1 launches per train step")
    require(eval_launches == 4, "expected 4 B1 launches per eval step")
    require(not launches.get("gcn_fused_fwd") and not launches.get("gcn_fused_bwd"),
            "the unfused path launched a fused kernel")
    require(launches["bce_sum"] == 2 * (TRAIN_STEPS + 1)
            and launches["bce_sum_bwd"] == TRAIN_STEPS,
            f"expected 2 BCE sum launches a step and 1 BCE gradient a train step: {launches}")
    bce_row = bce_phase(smi, launches)

    # ---- 6. B2 and B3 against their plain versions ----
    log("[6 B2/B3 vs plain] bench graph d=128 (f32, bf16); the hub graph, d=192 and tile "
        "256; dense 1024 graphs with an empty range of rows, d=32, and both kernels at the "
        f"widest admitted d={widest}")
    w, b = randn(D, D) / D ** 0.5, 0.1 * randn(D)
    errs_fused = {"gcn_fused_fwd": [], "gcn_fused_bwd": []}
    for key in ("f32", "bf16"):
        o = ops[key]
        x, ds, dx_dir = randn(N_PAD, D), randn(N_PAD, D), randn(N_PAD, D)
        ref = fused_fwd_plain(o.fwd, x, w, b)
        poison_allocator((N_PAD, D))
        errs_fused["gcn_fused_fwd"].append(compare(f"B2 {key} z", fused_fwd(o.fwd, x, w, b), ref))
        h_ref, dx_ref = fused_bwd_plain(o.bwd, ds, dx_dir, w)
        poison_allocator((2 * N_PAD, D))
        h, dx = fused_bwd(o.bwd, ds, dx_dir, w)
        errs_fused["gcn_fused_bwd"].append(compare(f"B3 {key} h", h, h_ref))
        errs_fused["gcn_fused_bwd"].append(compare(f"B3 {key} dx (atol of scale)", dx, dx_ref,
                                                   scaled=True))
    # the hub graph's rows of up to ~170 entries, d 192 (three 64-column W
    # chunks), and a tile-256 operator, which the edge-form kernels take like
    # any other
    for key, d in (("hub", D), ("f32", 192), ("tile256_min8", D)):
        o = ops[key]
        require(gcn_fused.fused_fits(o, d), f"fused_fits refuses {key} at d {d}")
        x, ds, dx_dir = randn(N_PAD, d), randn(N_PAD, d), randn(N_PAD, d)
        wd, bd = randn(d, d) / d ** 0.5, 0.1 * randn(d)
        ref = fused_fwd_plain(o.fwd, x, wd, bd)
        poison_allocator((N_PAD, d))
        errs_fused["gcn_fused_fwd"].append(
            compare(f"B2 {key} d={d} z", fused_fwd(o.fwd, x, wd, bd), ref))
        h_ref, dx_ref = fused_bwd_plain(o.bwd, ds, dx_dir, wd)
        poison_allocator((2 * N_PAD, d))
        h, dx = fused_bwd(o.bwd, ds, dx_dir, wd)
        errs_fused["gcn_fused_bwd"].append(compare(f"B3 {key} d={d} h", h, h_ref))
        errs_fused["gcn_fused_bwd"].append(compare(f"B3 {key} d={d} dx (atol of scale)", dx,
                                                   dx_ref, scaled=True))
    del x, ref, ds, dx_dir, h, dx, h_ref, dx_ref
    # rows and columns 512-639 hold no edge: every tile height leaves at least
    # one row block empty in both directions (z = tanh(b), h = 0, dx = dx_dir)
    for tile in (32, 64, 128, 256):
        rng = np.random.default_rng(tile)
        dense = (rng.random((1024, 1024)) < 0.01) * rng.random((1024, 1024))
        dense[512:640] = 0.0
        dense[:, 512:640] = 0.0
        g = from_dense(dense, device=cuda)
        o = bsr_from_graph(g, tile=tile, min_edges_per_tile=4, device=cuda)
        a64 = to_dense(g).double()
        d = 32
        x, ds, dx_dir = randn(1024, d), randn(1024, d), randn(1024, d)
        ws, bs = randn(d, d) / d ** 0.5, 0.1 * randn(d)
        ref = torch.tanh((a64 @ x.double()) @ ws.double() + bs.double()).float()
        poison_allocator((1024, d))
        errs_fused["gcn_fused_fwd"].append(
            compare(f"B2 dense tile={tile} d={d} vs float64", fused_fwd(o.fwd, x, ws, bs), ref))
        h64 = a64.T @ ds.double()
        poison_allocator((2 * 1024, d))
        h, dx = fused_bwd(o.bwd, ds, dx_dir, ws)
        errs_fused["gcn_fused_bwd"].append(
            compare(f"B3 dense tile={tile} h vs float64", h, h64.float()))
        errs_fused["gcn_fused_bwd"].append(compare(
            f"B3 dense tile={tile} dx vs float64", dx,
            (dx_dir.double() + h64 @ ws.double().T).float(), scaled=True))
    # both kernels at the widest width the fused layer admits (the smallest
    # CTA rows). atol of the summed terms' magnitude: each entry sums d
    # products in f32, whose rounding grows with the terms, not the result
    d = widest
    x, ws, bs = randn(1024, d), randn(d, d) / d ** 0.5, 0.1 * randn(d)
    x64 = a64 @ x.double()
    terms = ((a64 @ x.double().abs()) @ ws.double().abs() + bs.double().abs()).max().item()
    poison_allocator((1024, d))
    errs_fused["gcn_fused_fwd"].append(compare(
        f"B2 dense d={d} z vs float64 (atol of the terms' scale)", fused_fwd(o.fwd, x, ws, bs),
        torch.tanh(x64 @ ws.double() + bs.double()).float(), scale=terms))
    del x, x64
    ds, dx_dir = randn(1024, d), randn(1024, d)
    h64 = a64.T @ ds.double()
    poison_allocator((2 * 1024, d))
    h, dx = fused_bwd(o.bwd, ds, dx_dir, ws)
    errs_fused["gcn_fused_bwd"].append(compare(f"B3 dense d={d} h vs float64", h, h64.float()))
    terms = (dx_dir.double().abs() + h64.abs() @ ws.double().abs().T).max().item()
    errs_fused["gcn_fused_bwd"].append(compare(
        f"B3 dense d={d} dx vs float64 (atol of the terms' scale)", dx,
        (dx_dir.double() + h64 @ ws.double().T).float(), scale=terms))
    torch.cuda.synchronize()

    # ---- 7. FusedGatedLayer gradients ----
    log("[7 FusedGatedLayer grad] vs autograd of the plain version; "
        "loss touches x_next, z and g")
    x, u, bu = randn(N_PAD, D), 0.1 * randn(D, 1), 0.1 * randn(1)
    r1, r2, r3 = randn(N_PAD, D), randn(N_PAD, D), randn(N_PAD, 1)

    def layer_grads(layer):
        leaves = [t.clone().requires_grad_() for t in (x, w, b, u, bu)]
        xn, z, g = layer(*leaves)
        ((xn * r1).sum() + (z * r2).sum() + (g * r3).sum()).backward()
        return [t.grad for t in leaves]

    def plain_layer(x, w, b, u, bu):
        z = fused_fwd_plain(op.fwd, x, w, b)
        g = torch.sigmoid(z @ u + bu)
        return (1.0 - g) * x + g * z, z, g

    for name, got, ref in zip(("dx", "dw", "db", "du", "dbu"),
                              layer_grads(lambda *a: fused_gated_layer(op, *a)),
                              layer_grads(plain_layer)):
        compare(f"{name} (atol of scale)", got, ref, scaled=True)

    # ---- 8. the fused main path at full width ----
    log("[8 fused main path] fused='on' step vs unfused kernel-path step, dropout 0, "
        "same weights")
    state_f, state_u = new_state(0.0, "pallas", "on"), new_state(0.0, "pallas")
    require(state_f.model._use_fused(x_f, graph_bsr), "the full-width model does not fuse")
    _, loss_f, _ = chrome_train_step(state_f, x_f, x_r, graph_bsr, targets)
    _, loss_u, _ = chrome_train_step(state_u, x_f, x_r, graph_bsr, targets)
    rel = abs(loss_f.item() - loss_u.item()) / abs(loss_u.item())
    log(f"  loss fused {loss_f.item():.8f} unfused {loss_u.item():.8f} rel diff {rel:.2e} "
        "(tol 1e-5)")
    require(rel <= 1e-5, "fused and unfused train-step losses disagree")
    check_grads(state_f, state_u)
    del state_f, state_u

    state_fused = new_state(0.2, "auto", "on")
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    losses = [chrome_train_step(state_fused, x_f, x_r, graph_bsr, targets, gen_step)[1]
              for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    train_counts = gcn_launches()
    _build.LAUNCHES.clear()
    eval_loss, eval_probs = chrome_eval_step(state_fused, x_f, x_r, graph_bsr, targets)
    torch.cuda.synchronize()
    eval_counts = gcn_launches()
    losses = [l.item() for l in losses]
    log(f"  {TRAIN_STEPS} train steps (dropout 0.2) losses {['%.6f' % l for l in losses]}; "
        f"eval loss {eval_loss.item():.6f}")
    log(f"  launches: {train_counts} in {TRAIN_STEPS} train steps, {eval_counts} in 1 eval step")
    require(all(np.isfinite(losses)) and np.isfinite(eval_loss.item()), "non-finite fused loss")
    require(bool(torch.isfinite(eval_probs).all()), "non-finite fused probs")
    require(train_counts == {"gcn_fused_fwd": 4 * TRAIN_STEPS, "gcn_fused_bwd": 4 * TRAIN_STEPS},
            "expected 4 B2 + 4 B3 launches and no B1 per fused train step")
    require(eval_counts == {"gcn_fused_fwd": 4}, "expected 4 B2 launches per fused eval step")

    # ---- 9. the finetune CLI, -gcn_fused on ----
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="cli_", dir=os.path.join(here, "build"))
    try:
        argv = ["-dataroot", os.path.join(work, "data"), "-results_dir",
                os.path.join(work, "results"), "-cell_type", "SYN", "-load_pretrained",
                "-d_model", str(D), "-gcn_layers", str(LAYERS), "-optim", "sgd",
                "-lr", str(LR), "-gcn_dropout", "0.2", "-epochs", str(CLI_EPOCHS),
                "-adj_type", "hic", "-spmm_form", "bsr", "-gcn_fused", "on"]
        t0 = time.perf_counter()
        cli_cfg = write_cli_world(work, argv)
        log(f"[9 CLI] python -m chromegcn_tpu_torch.main {' '.join(argv[6:])}; synthetic "
            f"world {', '.join(f'{k} {c} {n} windows' for k, (c, n, _, _) in CLI_SPLITS.items())} "
            f"written in {time.perf_counter() - t0:.1f} s")
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        cli_main(argv)
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t0
        cli_counts = gcn_launches()
        logs = {}
        for split in ("train", "valid", "test"):
            with open(os.path.join(cli_cfg.run_dir, f"{split}.log")) as f:
                logs[split] = [[float(v) for v in line.split(",")] for line in f]
        for e in range(CLI_EPOCHS):
            log(f"  epoch {e + 1}: " + "; ".join(
                f"{split} loss {logs[split][e][1]:.6f} meanAUC {logs[split][e][3]:.4f}"
                for split in logs))
        log(f"  {CLI_EPOCHS} epochs in {t_cli:.1f} s (set-up included); launches {cli_counts}")
        # an epoch's metrics over one split's predictions, on the card as the
        # runner computes them, and on the host's CPU
        from chromegcn_tpu_torch.utils.evals import compute_metrics

        rng = np.random.default_rng(1)
        for split, (_, n, _, _) in CLI_SPLITS.items():
            preds = rng.random((n, NCLASS), dtype=np.float32)
            targs = (rng.random((n, NCLASS)) < 0.05).astype(np.float32)
            seconds = {}
            for where, calls in (("cuda", 5), ("cpu", 3)):
                seconds[where] = []
                for _ in range(calls):
                    t0 = time.perf_counter()
                    compute_metrics(preds, targs, 0.0, device=where)
                    seconds[where].append(time.perf_counter() - t0)
            log(f"  compute_metrics over {split}'s {n} x {NCLASS} predictions, median "
                f"(min-max) of {len(seconds['cuda'])} and {len(seconds['cpu'])} calls: card "
                f"{np.median(seconds['cuda']):.3f} s ({min(seconds['cuda']):.3f}-"
                f"{max(seconds['cuda']):.3f}), host CPU {np.median(seconds['cpu']):.3f} s "
                f"({min(seconds['cpu']):.3f}-{max(seconds['cpu']):.3f})")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    require(all(len(v) == CLI_EPOCHS for v in logs.values()), "CLI logged a wrong epoch count")
    require(all(np.isfinite(row[1]) for v in logs.values() for row in v), "non-finite CLI loss")
    # per epoch: 4 B2 + 4 B3 for the train chromosome, 4 B2 per eval chromosome
    require(cli_counts == {"gcn_fused_fwd": CLI_EPOCHS * 12, "gcn_fused_bwd": CLI_EPOCHS * 4},
            "expected 12 B2 and 4 B3 launches per CLI epoch, and no B1")

    # ---- 10. timings ----
    log(f"[10 timings] {smi}")
    x = randn(N_PAD, D)
    ne = graph.n_edges
    adj_csr = csr_of(graph)
    errs["library"] = compare("torch.sparse.mm (CSR) vs kernel, fwd d=128",
                              torch.sparse.mm(adj_csr, x), bsr_matmul(op.fwd, x))
    # the headline: device time per call (torch.profiler, every kernel the
    # call runs), median (min-max) of 3 runs of 20 in turns; the CUDA-event
    # loops beside it are a record, the host's launch gaps included
    b1_fns = {
        "fwd": lambda: bsr_matmul(op.fwd, x),
        "bwd": lambda: bsr_matmul(op.bwd, x),
        "plain": lambda: bsr_matmul_plain(op.fwd, x),
        "library": lambda: torch.sparse.mm(adj_csr, x),
    }
    t = t_b1 = device_times(b1_fns)
    ev = cuda_ms(b1_fns)
    t_fwd, t_plain, t_lib = (statistics.median(t[k]) for k in ("fwd", "plain", "library"))
    ev_fwd = statistics.median(ev["fwd"])
    b_ms, b_by, b_bytes, b_flops = bound(op.fwd, D)
    log(f"  B1 f32 d=128 device ms per call (torch.profiler, median (min-max) of 3 runs of 20 "
        f"in turns): fwd {spread(t['fwd'])}; bwd {spread(t['bwd'])}; plain {spread(t['plain'])}; "
        f"torch.sparse.mm CSR {spread(t['library'])}")
    log(f"  record, not the headline: CUDA-event ms per call (median (min-max) of 5 loops of 20 "
        f"in turns, host launch gaps included): fwd {spread(ev['fwd'])}; bwd "
        f"{spread(ev['bwd'])}; plain {spread(ev['plain'])}; torch.sparse.mm CSR "
        f"{spread(ev['library'])}")
    shares = {"B1 f32 d=128": b_ms / t_fwd}
    log(f"  bound {b_ms:.4f} ms by {b_by} ({b_bytes / 1e6:.1f} MB: {op.fwd.nnz} nonzeros' "
        f"values and columns, row pointers, x and out; {b_flops / 1e9:.4f} GFLOP); kernel at "
        f"{100 * shares['B1 f32 d=128']:.1f}% of it, torch.sparse.mm at {100 * b_ms / t_lib:.1f}%"
        f" (device times)")
    log(f"  block form (not the bound): {elems} live block elements, "
        f"{block_bytes / 1e6:.1f} MB with their indices, for {ne} edges")
    for key, d in (("f32", 2 * D), ("bf16", D), ("bf16", 2 * D), ("hub", D), ("f32", 1850),
                   ("f32", 925)):
        m = ops[key].fwd
        xd = randn(N_PAD, d)
        fns = {key: lambda: bsr_matmul(m, xd)}
        tk, tk_ev = device_times(fns)[key], cuda_ms(fns)[key]
        bm, by, _, _ = bound(m, d)
        shares[f"B1 {key} d={d}"] = bm / statistics.median(tk)
        log(f"  B1 fwd {key} d={d}: device {spread(tk)} ms per launch (events {spread(tk_ev)}); "
            f"bound {bm:.4f} ms by {by} ({100 * shares[f'B1 {key} d={d}']:.1f}%)")
    del xd

    # B2 and B3 at the main path's shapes; the yardstick composes
    # torch.sparse.mm (CSR) with the epilogue's ops, as no single call does both
    ds, dx_dir = randn(N_PAD, D), randn(N_PAD, D)
    adj_t_csr = csr_of(graph, transpose=True)
    h_f = bsr_matmul(op.fwd, x)  # B2's h: B1 over op.fwd is the same gather
    h_t = bsr_matmul(op.bwd, ds)  # B3's h, over op.bwd
    compare("library tanh(sparse.mm(A, x) @ w + b) vs B2",
            torch.tanh(torch.sparse.mm(adj_csr, x) @ w + b), fused_fwd(op.fwd, x, w, b))
    fused_fns = {
        "B2": lambda: fused_fwd(op.fwd, x, w, b),
        "B2 plain": lambda: fused_fwd_plain(op.fwd, x, w, b),
        "B2 library": lambda: torch.tanh(torch.sparse.mm(adj_csr, x) @ w + b),
        "B2 epilogue GEMM": lambda: torch.tanh(torch.addmm(b, h_f, w)),
        "B3": lambda: fused_bwd(op.bwd, ds, dx_dir, w),
        "B3 plain": lambda: fused_bwd_plain(op.bwd, ds, dx_dir, w),
        "B3 library": lambda: torch.addmm(dx_dir, torch.sparse.mm(adj_t_csr, ds), w.T),
        "B3 epilogue GEMM": lambda: torch.addmm(dx_dir, h_t, w.T),
    }
    t = device_times(fused_fns)
    ev = cuda_ms(fused_fns)
    fused_rows = {}
    for kernel, key, m, bwd in (("gcn_fused_fwd", "B2", op.fwd, False),
                                ("gcn_fused_bwd", "B3", op.bwd, True)):
        ms, ms_plain, ms_lib = (statistics.median(t[k]) for k in (key, f"{key} plain",
                                                                   f"{key} library"))
        fb_ms, fb_by, fb_bytes, fb_flops = fused_bound(m, D, bwd)
        ffma_ms, ffma_by, _, _ = fused_bound(m, D, bwd, epi_rate=PEAK_FLOPS[torch.float32])
        fused_rows[kernel] = (ms, ms_plain, ms_lib, fb_ms, fb_by, statistics.median(ev[key]))
        shares[key] = fb_ms / ms
        log(f"  {key} f32 d=128 device ms per call, median (min-max) of 3 runs of 20 in turns: "
            f"kernel {spread(t[key])}; plain {spread(t[f'{key} plain'])}; library "
            f"composition {spread(t[f'{key} library'])}; bound {fb_ms:.4f} ms by {fb_by} "
            f"({fb_bytes / 1e6:.1f} MB, {fb_flops / 1e9:.4f} GFLOP, the GEMM at 3xTF32's "
            f"{TF32X3_FLOPS / 1e12:.0f} TFLOP/s); kernel at {100 * shares[key]:.1f}% of it, "
            f"library composition at {100 * fb_ms / ms_lib:.1f}%; record, not the bound: "
            f"with the GEMM at f32 FFMA's 67 TFLOP/s it would read {ffma_ms:.4f} ms by "
            f"{ffma_by}")
        log(f"  record, not the headline: {key} CUDA-event ms per call (5 loops of 20, host "
            f"launch gaps included): kernel {spread(ev[key])}; plain "
            f"{spread(ev[f'{key} plain'])}; library composition {spread(ev[f'{key} library'])}")
    for key, kind, direction, gemm in (
            ("B2", "fwd", "op.fwd", "torch.tanh(torch.addmm(b, h, w))"),
            ("B3", "bwd", "op.bwd", "torch.addmm(dx_dir, h, w.T)")):
        log(f"  {key}'s two halves apart (device ms): B1 over {direction} (the same gather, "
            f"writes h) {spread(t_b1[kind])}; the epilogue in cuBLAS, {gemm} in f32, "
            f"{spread(t[f'{key} epilogue GEMM'])}")
    del x, ds, dx_dir, h_f, h_t
    # a share above 100% would mean the bound counts less than the work needs
    require(all(v <= 1.0 for v in shares.values()), f"a share of bound above 100%: {shares}")

    state_p = new_state(0.2, "xla")
    steps = host_ms({
        "train": lambda: chrome_train_step(state, x_f, x_r, graph_bsr, targets, gen_step),
        "fused train": lambda: chrome_train_step(state_fused, x_f, x_r, graph_bsr, targets,
                                                 gen_step),
        "coo train": lambda: chrome_train_step(state_p, x_f, x_r, graph_bsr, targets, gen_step),
        "eval": lambda: chrome_eval_step(state, x_f, x_r, graph_bsr, targets),
        "fused eval": lambda: chrome_eval_step(state_fused, x_f, x_r, graph_bsr, targets),
    })
    del state_p
    # bench.py's convention: each edge passes per layer, per strand, fwd + bwd
    edges_per_step = ne * LAYERS * 2 * 2
    t_step, t_fused_step = (statistics.median(steps[k]) for k in ("train", "fused train"))
    log(f"  host ms per step, median (min-max) of 5 loops of 5 in turns: train "
        f"{spread(steps['train'])} = {edges_per_step / t_step / 1e3:.1f} M edges/s; fused "
        f"train {spread(steps['fused train'])} = {edges_per_step / t_fused_step / 1e3:.1f} M "
        f"edges/s; plain COO path train {spread(steps['coo train'])}; eval "
        f"{spread(steps['eval'])}; fused eval {spread(steps['fused eval'])}")
    log(f"  8 B1 launches at fwd time make {8 * t_fwd:.4f} ms; 4 B2 + 4 B3 launches make "
        f"{4 * fused_rows['gcn_fused_fwd'][0] + 4 * fused_rows['gcn_fused_bwd'][0]:.4f} ms")

    if args.profile:
        log("  unfused train step:")
        profile_steps(lambda: chrome_train_step(state, x_f, x_r, graph_bsr, targets, gen_step),
                      t_step)
        log("  fused train step:")
        profile_steps(lambda: chrome_train_step(state_fused, x_f, x_r, graph_bsr, targets,
                                                gen_step), t_fused_step)

    # ---- 11. the window models on the card against the CPU ----
    from chromegcn_tpu_torch.data.constants import SRC_VOCAB
    from chromegcn_tpu_torch.models.window import make_window_model
    from chromegcn_tpu_torch.ops.seq import complement_permutation
    from chromegcn_tpu_torch.train.pretrain import (
        create_window_state, window_eval_step, window_train_step,
    )

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    comp = {dev: torch.as_tensor(complement_permutation(SRC_VOCAB), device=dev)
            for dev in (cpu, cuda)}
    log(f"[11 window models] seq {SEQ_LEN}, {NCLASS} labels, d_model {D}: card vs CPU from "
        "the same weights, in the f32 parity mode (TF32 off; cuDNN off but for the LSTMs). "
        "Eval forward of 8 sequences in f32 within 1e-4 of its scale of the CPU's. One train "
        "step on 4 (dropout "
        "0): in float64 on the card, every grad within 1e-9 of its scale of float64 on the "
        "CPU; in f32 on the card, the loss within rel 1e-4 of float64's and every grad within "
        "1e-4 of its scale, but Expecto's below bn3 (reported)")
    rng = np.random.default_rng(3)
    tok8 = rng.integers(0, 5, size=(8, SEQ_LEN)).astype(np.int32)
    tgt4 = (rng.random((4, NCLASS)) < 0.05).astype(np.float32)
    mask4 = np.ones(4, bool)
    for name in WINDOW_MODELS:
        states = {key: create_window_state(
            no_dropout(make_window_model(name, NCLASS, seq_length=SEQ_LEN, d_model=D)),
            "adam", WINDOW_LR, seed=0, device=cuda if key.startswith("card") else cpu)
            for key in ("card", "card64", "cpu", "cpu64")}
        require(not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32
                     or torch.backends.cudnn.enabled),
                "create_window_state left TF32 or cuDNN on")
        got = window_eval_step(states["card"], tok8, np.zeros((8, NCLASS), np.float32),
                               np.ones(8, bool), comp[cuda])
        ref = window_eval_step(states["cpu"], tok8, np.zeros((8, NCLASS), np.float32),
                               np.ones(8, bool), comp[cpu], device=cpu)
        for what, a, b in zip(("loss", "probs", "x_fwd", "x_rev"), got, ref):
            err, scale = (a.cpu() - b).abs().max().item(), b.abs().max().item()
            log(f"  {name} eval {what}: max_abs_err {err:.3e} ({err / scale:.2e} of scale; "
                "tol 1e-4)")
            require(bool(torch.isfinite(a).all()) and err <= 1e-4 * scale,
                    f"{name}: the card's eval {what} disagrees with the CPU's")
        loss = window_train_step(states["card"], tok8[:4], tgt4, mask4, comp[cuda])[1].item()
        train_grads(states["card64"].model, tok8[:4], tgt4, comp[cuda])
        loss64 = train_grads(states["cpu64"].model, tok8[:4], tgt4, comp[cpu])
        rel = abs(loss - loss64) / abs(loss64)
        log(f"  {name} train loss card {loss:.8f}, CPU float64 {loss64:.8f}: rel diff "
            f"{rel:.2e} (tol 1e-4)")
        require(rel <= 1e-4, f"{name}: the card's train-step loss disagrees with float64's")
        held, below_bn, worst64 = [], [], 0.0
        names = [n for n, _ in trained(states["card"].model)]
        # Expecto's gradients below bn3 pass back through train-mode BatchNorms
        # over near-constant ReLU'd channels: ill-conditioned in f32 on any
        # device (up to ~1e-1 of scale from float64 there, which this phase
        # reports); the float64 comparison holds them
        first_held = names.index("model.bn3.weight") if name == "expecto" else 0
        for i, (pname, (_, pg), (_, p64g), (_, p64)) in enumerate(zip(
                names, *(trained(states[k].model) for k in ("card", "card64", "cpu64")))):
            scale = p64.grad.abs().max().item()
            err64 = (p64g.grad.cpu() - p64.grad).abs().max().item() / scale
            require(err64 <= 1e-9, f"{name}: float64 grad {pname} is {err64:.2e} of its scale "
                    "from the CPU's")
            worst64 = max(worst64, err64)
            err = (pg.grad.double().cpu() - p64.grad).abs().max().item() / scale
            if i >= first_held:
                require(err <= 1e-4, f"{name}: f32 grad {pname} is {err:.2e} of its scale "
                        "from float64")
                held.append((err, pname))
            else:
                below_bn.append((err, pname))
        log(f"  {name} float64 grads card vs CPU: worst {worst64:.2e} of scale (tol 1e-9)")
        log(f"  {name} f32 grads vs float64: {len(held)} held within 1e-4 of scale, worst "
            f"{max(held)[1]} at {max(held)[0]:.2e}" + (
                f"; below bn3 (reported): worst {max(below_bn)[1]} at {max(below_bn)[0]:.2e}"
                if below_bn else ""))
        # a record, not the port's mode: the same f32 grads through cuDNN
        p64 = dict(trained(states["cpu64"].model))
        for mode, tf32 in (("cuDNN, TF32 off", False), ("cuDNN and TF32", True)):
            st = create_window_state(
                no_dropout(make_window_model(name, NCLASS, seq_length=SEQ_LEN, d_model=D)),
                "adam", WINDOW_LR, seed=0, device=cuda)
            torch.backends.cudnn.enabled = True
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                train_grads(st.model, tok8[:4], tgt4, comp[cuda], torch.float32)
            finally:
                torch.backends.cudnn.enabled = False
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
            rec = [(((pg.grad.double().cpu() - p64[n].grad).abs().max()
                     / p64[n].grad.abs().max()).item(), n)
                   for n, pg in trained(st.model)][first_held:]
            log(f"  {name} f32 grads with {mode} (a record): worst {max(rec)[1]} at "
                f"{max(rec)[0]:.2e} of scale")
            del st
        del states
    log(f"  done in {time.perf_counter() - t0:.1f} s")

    # ---- 12. the full-width pretrain step ----
    log(f"[12 pretrain step] {smi}; batch {WINDOW_BATCH} windows ({2 * WINDOW_BATCH} "
        f"sequences with both strands), seq {SEQ_LEN}, {NCLASS} labels, Adam lr {WINDOW_LR}, "
        "dropout on; host ms, median (min-max) of 5 loops of 5 steps")
    rng = np.random.default_rng(4)
    tok = torch.as_tensor(rng.integers(0, 5, size=(WINDOW_BATCH, SEQ_LEN)).astype(np.int32),
                          device=cuda)
    tgt = torch.as_tensor((rng.random((WINDOW_BATCH, NCLASS)) < 0.05).astype(np.float32),
                          device=cuda)
    mask = torch.ones(WINDOW_BATCH, dtype=torch.bool, device=cuda)
    gen_w = torch.Generator(device=cuda).manual_seed(0)
    for name in WINDOW_MODELS:
        wstate = create_window_state(make_window_model(name, NCLASS, SEQ_LEN, D), "adam",
                                     WINDOW_LR, seed=0, device=cuda)
        flops = window_flops(wstate.model.model, 2 * WINDOW_BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fns = {
            "train": lambda: window_train_step(wstate, tok, tgt, mask, comp[cuda], gen_w),
            "eval": lambda: window_eval_step(wstate, tok, tgt, mask, comp[cuda]),
        }
        t = host_ms(fns)
        peak = torch.cuda.max_memory_allocated()
        t_train, t_eval = statistics.median(t["train"]), statistics.median(t["eval"])
        # forward + backward ~ 3 forwards; f32 FFMA's peak, TF32 being off
        t_bound = 3 * flops / PEAK_FLOPS[torch.float32] * 1e3
        log(f"  {name}: train {spread(t['train'])} ms = "
            f"{WINDOW_BATCH / t_train * 1e3:.1f} windows/s; eval {spread(t['eval'])} ms = "
            f"{WINDOW_BATCH / t_eval * 1e3:.1f} windows/s; peak device memory "
            f"{peak / 2**30:.2f} GiB; forward {flops / 1e9:.1f} GFLOP, train step ~3x = "
            f"{3 * flops / 1e12:.2f} TFLOP, {3 * flops / t_train / 1e9:.1f} TFLOP/s, bound "
            f"{t_bound:.1f} ms at f32's {PEAK_FLOPS[torch.float32] / 1e12:.0f} TFLOP/s "
            f"({100 * t_bound / t_train:.1f}%)")
        if name == "expecto":
            # what f32-faithfulness costs: cuDNN with TF32 off (not f32-faithful
            # in its backward convolutions), and the fast mode (cuDNN and TF32)
            alt = {}
            for mode, tf32 in (("cuDNN, TF32 off", False), ("cuDNN and TF32", True)):
                torch.backends.cudnn.enabled = True
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
                try:
                    alt[mode] = host_ms({"train": fns["train"]})["train"]
                finally:
                    torch.backends.cudnn.enabled = False
                    torch.backends.cudnn.allow_tf32 = False
                    torch.backends.cuda.matmul.allow_tf32 = False
            log("  expecto train step in the other modes: " + "; ".join(
                f"{mode} {spread(ts)} ms" for mode, ts in alt.items())
                + f" (the port's f32 parity mode: {spread(t['train'])} ms)")
            if args.profile:
                log("  expecto train step:")
                profile_steps(fns["train"], t_train, groups=WINDOW_PROFILE_GROUPS)
        del wstate, fns
    del tok, tgt, mask

    # ---- 13. the pipeline through the CLI ----
    work = tempfile.mkdtemp(prefix="pipeline_", dir=os.path.join(here, "build"))
    try:
        base = ["-dataroot", os.path.join(work, "data"), "-results_dir",
                os.path.join(work, "results"), "-cell_type", "SYN", "-seq_length", str(SEQ_LEN),
                "-batch_size", str(WINDOW_BATCH), "-adj_type", "hic"]
        expecto = base + ["-window_model", "expecto", "-d_model", str(D)]
        t0 = time.perf_counter()
        splits = write_pipeline_world(expecto)
        log(f"[13 pipeline] python -m chromegcn_tpu_torch.main, synthetic world "
            f"{', '.join(f'{s} {chroms}' for s, chroms in PIPELINE_SPLITS.items())} windows, "
            f"seq {SEQ_LEN}, {NCLASS} labels (~30% positive: make_window_dataset's motifs); "
            f"written in {time.perf_counter() - t0:.1f} s")
        cfg_e = cli_config(expecto + ["-pretrain"])
        modes = {"pretrain": ["-pretrain", "-epochs", "2"], "save_feats": ["-save_feats"],
                 "finetune": ["-load_pretrained", "-epochs", "2", "-gcn_fused", "on"]}
        pipe_counts = {}
        for mode, extra in modes.items():
            _build.LAUNCHES.clear()
            out, secs = run_cli(cli_main, expecto + extra)
            pipe_counts[mode] = gcn_launches()
            log(f"  expecto {' '.join(extra)}: {secs:.1f} s; launches {pipe_counts[mode]}")
            for line in out:
                if "warm-started" in line or "restored" in line or "epoch" in line:
                    log(f"    {line}")
            if mode == "pretrain":
                logs = read_logs(cfg_e.stage1_run_dir)
            elif mode == "finetune":
                require(any("warm-started GCN head from CNN checkpoint" in l for l in out),
                        "the finetune did not log its warm start")
                logs = read_logs(cli_config(expecto + extra).run_dir)
            else:
                continue
            for e, rows in enumerate(zip(*(logs[s] for s in ("train", "valid", "test")))):
                log(f"    epoch {e + 1}: " + "; ".join(
                    f"{s} loss {r[1]:.6f} meanAUC {r[3]:.4f}"
                    for s, r in zip(("train", "valid", "test"), rows)))
            require(all(len(v) == 2 for v in logs.values()), f"{mode} logged a wrong epoch count")
            require(all(np.isfinite(r[1]) for v in logs.values() for r in v),
                    f"non-finite {mode} loss")
        require(len(read_logs(cfg_e.stage1_run_dir)["test"]) == 2,
                "-save_feats did not keep the two pretrain rows of the stage-1 logs")
        from chromegcn_tpu_torch.data.loader import load_chrom_features

        for split, ds in splits.items():
            feats = load_chrom_features(cfg_e.feature_path(split))
            require(list(feats) == ds.chrom_order(), f"{split}: saved chromosomes out of order")
            for chrom, cf in feats.items():
                sel = ds.chroms == chrom
                require(cf.forward.shape == cf.backward.shape == (int(sel.sum()), D)
                        and np.isfinite(cf.forward).all() and np.isfinite(cf.backward).all(),
                        f"{split} {chrom}: features of a wrong shape or non-finite")
                require(np.array_equal(cf.starts, ds.starts[sel])
                        and np.array_equal(cf.target, ds.targets[sel]),
                        f"{split} {chrom}: features out of the windows' order")
        log(f"  saved features: {D} columns per strand, every split's windows in order")
        # per epoch: 2 train chromosomes x (4 B2 + 4 B3), 4 B2 per eval chromosome
        require(pipe_counts["finetune"] == {"gcn_fused_fwd": 2 * (8 + 4 + 4),
                                            "gcn_fused_bwd": 2 * 8},
                "expected 16 B2 and 8 B3 launches per finetune epoch, and no B1")
        require(not pipe_counts["pretrain"] and not pipe_counts["save_feats"],
                "the window stage launched a GCN kernel")

        # ChromeRNN on the saved features, and joint training warm-started
        # from Expecto's stage-1 checkpoint
        for mode, extra, warm in (
                ("rnn", ["-load_pretrained", "-chrome_model", "rnn", "-epochs", "1"],
                 "warm-started GCN head from CNN checkpoint"),
                ("joint", ["-joint", "-epochs", "1", "-gcn_fused", "on"],
                 "joint: warm-started CNN + GCN head from pretrain checkpoint")):
            _build.LAUNCHES.clear()
            out, secs = run_cli(cli_main, expecto + extra)
            pipe_counts[mode] = gcn_launches()
            run_dir = cli_config(expecto + extra).run_dir + (".joint" if mode == "joint" else "")
            logs = read_logs(run_dir)
            log(f"  expecto {' '.join(extra)}: {secs:.1f} s; launches {pipe_counts[mode]}; "
                + "; ".join(f"{s} loss {logs[s][0][1]:.6f} meanAUC {logs[s][0][3]:.4f}"
                            for s in ("train", "valid", "test")))
            require(any(warm in line for line in out), f"the {mode} run did not log its warm start")
            require(all(len(v) == 1 for v in logs.values()), f"{mode} logged a wrong epoch count")
            require(all(np.isfinite(r[1]) for v in logs.values() for r in v),
                    f"non-finite {mode} loss")
        require(not pipe_counts["rnn"], "ChromeRNN launched a GCN kernel")

        # the hybrid operator through the CLI: B1 over both of its parts,
        # and no fused kernel
        from chromegcn_tpu_torch.train.runner import build_split_graphs

        extra = ["-load_pretrained", "-spmm_form", "hybrid", "-epochs", "1"]
        _build.LAUNCHES.clear()
        out, secs = run_cli(cli_main, expecto + extra)
        pipe_counts["hybrid"] = gcn_launches()
        cfg_h = cli_config(expecto + extra)
        logs = read_logs(cfg_h.run_dir)
        per_product = {}
        for split in ("train", "valid", "test"):
            graphs = build_split_graphs(cfg_h, load_chrom_features(cfg_h.feature_path(split)),
                                        split, device=cuda, verbose=lambda *_: None)
            per_product[split] = [launches_per_product(g.bsr) for g in graphs.values()]
        # 2 strands x 2 layers, forward and backward, per train chromosome;
        # the forward per valid and test chromosome
        want_b1 = 8 * sum(per_product["train"]) + 4 * sum(per_product["valid"]
                                                          + per_product["test"])
        log(f"  expecto {' '.join(extra)}: {secs:.1f} s; launches {pipe_counts['hybrid']} "
            f"(B1 launches per product, by chromosome: {per_product}); "
            + "; ".join(f"{s} loss {logs[s][0][1]:.6f} meanAUC {logs[s][0][3]:.4f}"
                        for s in ("train", "valid", "test")))
        require(any("attached the hybrid operator" in line for line in out),
                "the hybrid run did not attach the hybrid operator")
        require(all(len(v) == 1 for v in logs.values())
                and all(np.isfinite(r[1]) for v in logs.values() for r in v),
                "the hybrid run logged a wrong epoch count or a non-finite loss")
        require(pipe_counts["hybrid"] == {"bsr_spmm": want_b1},
                f"expected {want_b1} B1 launches and no B2 or B3 in the hybrid epoch")
        # 2 train chromosomes x (4 B2 + 4 B3), 4 B2 per eval chromosome
        require(pipe_counts["joint"] == {"gcn_fused_fwd": 2 * 4 + 2 * 4, "gcn_fused_bwd": 2 * 4},
                "expected 16 B2 and 8 B3 launches per joint epoch, and no B1")

        danq = base + ["-window_model", "danq", "-d_model", "925"]
        for extra in (["-pretrain", "-epochs", "1"], ["-save_feats"]):
            _, secs = run_cli(cli_main, danq + extra)
            log(f"  danq {' '.join(extra)}: {secs:.1f} s")
        cfg_d = cli_config(danq + ["-save_feats"])
        widths = {load_chrom_features(cfg_d.feature_path(s))[c].forward.shape[1]
                  for s, chroms in PIPELINE_SPLITS.items() for c in chroms}
        require(widths == {925}, f"DanQ's saved features are {widths} wide, not 925")
        try:
            run_cli(cli_main, danq + ["-load_pretrained", "-epochs", "1", "-gcn_fused", "on"])
        except KeyError as e:
            log(f"  danq -load_pretrained stops at the warm start, as the reference's does: "
                f"KeyError {e}")
            require("only Expecto" in str(e), "DanQ's finetune stopped with another KeyError")
        else:
            require(False, "DanQ's finetune ran past the warm start")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- 17. the full chr1-scale world; 18. analysis ----
    t0 = time.perf_counter()
    full = fullscale_phase(args, smi, graph, {"bench": statistics.median(t_b1["fwd"]),
                                              "bench bwd": statistics.median(t_b1["bwd"])})
    log(f"  done in {time.perf_counter() - t0:.1f} s")
    b1_analysis = analysis_phase(smi, graph, x_f, x_r, targets, comp[cuda])

    # ---- 19. the parallel paths at full chr1 scale ----
    t0 = time.perf_counter()
    sharded = parallel_phase(args, smi, full.pop("graph"), full.pop("flat"))
    log(f"  done in {time.perf_counter() - t0:.1f} s")

    # ---- 14. ChromeRNN at bench scale; 15. the joint step ----
    rnn_phase(args, smi, graph, x_f, x_r, targets)
    joint_phase(args, smi, comp[cuda])

    # ---- 16. the host ingest at full chr1, then on to the card ----
    ingest = ingest_phase(args, smi, here)

    # ---- 20. result ----
    kernels = [{
        "name": "bsr_spmm",
        "route": "cuda",
        "source": "chromegcn_tpu_torch/csrc/bsr_spmm.cu",
        "replaces": "chromegcn_tpu/ops/spmm_pallas.py:289",
        "launches": launches["bsr_spmm"],
        "launches_hybrid_train_step": full["launches_hybrid_train_step"],
        "launches_hybrid_cli_epoch": pipe_counts["hybrid"]["bsr_spmm"],
        "launches_analysis": b1_analysis,
        # phase 19: the sharded train step at 4 in-process shards, and the
        # one-rank NCCL step
        "launches_sharded_train_step": sharded["launches_sharded_train_step"],
        "launches_nccl_train_step": sharded["launches_nccl_train_step"],
        "event_ms_sharded_product": sharded["event_ms_sharded"],
        # phase 16: the train step and the CLI chain's finetune epoch over
        # graphs the port's ingest built
        "launches_ingest_train_step": ingest["launches_ingest_train_step"],
        "launches_ingest_cli_epoch": ingest["launches_ingest_cli_epoch"],
        "event_ms_ingest": ingest["event_ms_ingest"],
        "bound_ms_ingest": ingest["bound_ms_ingest"],
        "max_abs_err": max([v for k, v in errs.items() if k != "library"]
                           + [full["max_abs_err_fullscale"], sharded["max_abs_err_sharded"],
                              ingest["max_abs_err_ingest"]]),
        "ms": t_fwd,
        "event_ms_fullscale": full["event_ms_fullscale"],
        "bound_ms_fullscale": full["bound_ms_fullscale"],
        "event_ms": ev_fwd,
        "plain_ms": t_plain,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": t_lib,
    }] + [{
        "name": kernel,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        # the CLI's run (phase 9), the slice's main path
        "launches": cli_counts[kernel],
        "max_abs_err": max(errs_fused[kernel] + [full["fused_fullscale"][kernel]
                                                 ["max_abs_err_fullscale"]]),
        "ms": fused_rows[kernel][0],
        "event_ms": fused_rows[kernel][5],
        "plain_ms": fused_rows[kernel][1],
        "bound_ms": fused_rows[kernel][3],
        "bound_by": fused_rows[kernel][4],
        "library_ms": fused_rows[kernel][2],
        # phase 17: alone over the full chr1-scale world's flat form
        **{k: v for k, v in full["fused_fullscale"][kernel].items()
           if k != "max_abs_err_fullscale"},
    } for kernel, source, replaces in (
        ("gcn_fused_fwd", "chromegcn_tpu_torch/csrc/gcn_fused.cu",
         "chromegcn_tpu/ops/gcn_fused.py:85"),
        ("gcn_fused_bwd", "chromegcn_tpu_torch/csrc/gcn_fused_bwd.cu",
         "chromegcn_tpu/ops/gcn_fused.py:206"))] + [bce_row]
    log(f"[20 done] in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
