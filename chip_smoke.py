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
   launches (8 B1 per train step, 4 per eval step);
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
10. timings after warm-up, each the median (min-max) of 5 loops, the
   functions of a group timed in turns: B1, B2 and B3 per launch with CUDA
   events, their plain versions and a library yardstick the port never
   calls (torch.sparse.mm over CSR, composed with the epilogue's ops for
   B2/B3), and B2's and B3's gather and epilogue apart; each kernel's device
   time per launch from torch.profiler (the event loops include the host's
   launch gaps when the host is slow); each kernel's share
   of its bound (what the data needs: the edge list, the dense arrays,
   2 nnz d operations plus the epilogue GEMM at 3xTF32's rate); the train
   and eval steps, unfused and fused, on the host clock;
11. the window models (Expecto, DeepSEA, DanQ) at full width (seq 2,000,
   919 labels, d_model 128) on the card against the same weights on the
   CPU: a NonStrandSpecific eval forward of 8 sequences, and one train step
   on a batch of 4 with dropout 0: in float64 on the card against float64
   on the CPU (every gradient), and in f32 on the card against float64 (the
   loss, and every gradient but Expecto's below bn3, which pass back through
   train-mode BatchNorms over near-constant channels and land up to ~1e-1 of
   scale from float64 in f32 on any device); this holds the f32 parity mode
   (TF32 and cuDNN off) faithful and the layouts right on the card;
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
   launches counted); then DanQ -pretrain -epochs 1 and -save_feats (925
   columns), whose finetune stops at the warm start as the reference's does;
14. a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Any failed phase ends the run with a non-zero exit code.

``python3 chip_smoke.py --profile`` adds to phases 10 and 12 a
torch.profiler trace of 3 train steps of each path: device time per step by
kernel or kernel group, and the device's idle share of the step.
"""

import argparse
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
KERNELS = ("bsr_spmm", "gcn_fused", "gcn_fused_bwd")
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


def device_ms(fn, match, iters=20):
    """Device time (ms) per call of ``fn``, summed over the kernels whose
    name holds ``match``, from torch.profiler over ``iters`` calls after
    warm-up: the kernel's own time, without the host's launch gaps, which
    the CUDA-event loops of ``cuda_ms`` include when the host is slow."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and match in evt.key:
            us = getattr(evt, "self_device_time_total", None)
            total_us += evt.self_cuda_time_total if us is None else us
    return total_us / iters / 1e3


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
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / steps / 1e3, evt.key, evt.count // steps))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        log("  profile: the profiler reported no device time")
        return
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


def no_dropout(model):
    """p = 0 on every nn.Dropout and on the LSTM (the window models' rates are
    the architecture's, with no flag to turn them off)."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        elif isinstance(m, torch.nn.LSTM):
            m.dropout = 0.0
    return model


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
    import contextlib
    import io

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    torch.cuda.synchronize()
    return buf.getvalue().splitlines(), time.perf_counter() - t0


def read_logs(run_dir):
    logs = {}
    for split in ("train", "valid", "test"):
        with open(os.path.join(run_dir, f"{split}.log")) as f:
            logs[split] = [[float(v) for v in line.split(",")] for line in f]
    return logs


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
    from chromegcn_tpu_torch.models.chrome import make_chrome_model
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
    from chromegcn_tpu_torch.train.finetune import (
        chrome_eval_step, chrome_train_step, create_chrome_state,
    )

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

    def new_state(dropout, impl, fused="off"):
        model = make_chrome_model("gcn", nclass=NCLASS, dropout=dropout, layers=LAYERS,
                                  nfeat=D, spmm_impl=impl, fused=fused)
        return create_chrome_state(model, "sgd", LR, seed=0, device=cuda)

    def check_grads(state, ref_state):
        # sums over 50k rows in another order: 1e-4 of each grad's scale
        for (name, pk), pp in zip(state.model.named_parameters(), ref_state.model.parameters()):
            err = (pk.grad - pp.grad).abs().max().item()
            scale = pp.grad.abs().max().item()
            log(f"  grad {name}: max_abs_err {err:.3e} (tol {1e-4 * scale + 1e-8:.3e})")
            require(err <= 1e-4 * scale + 1e-8, f"grad {name} disagrees")

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
    train_counts = dict(_build.LAUNCHES)
    _build.LAUNCHES.clear()
    eval_loss, eval_probs = chrome_eval_step(state_fused, x_f, x_r, graph_bsr, targets)
    torch.cuda.synchronize()
    eval_counts = dict(_build.LAUNCHES)
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
        cli_counts = dict(_build.LAUNCHES)
        logs = {}
        for split in ("train", "valid", "test"):
            with open(os.path.join(cli_cfg.run_dir, f"{split}.log")) as f:
                logs[split] = [[float(v) for v in line.split(",")] for line in f]
        for e in range(CLI_EPOCHS):
            log(f"  epoch {e + 1}: " + "; ".join(
                f"{split} loss {logs[split][e][1]:.6f} meanAUC {logs[split][e][3]:.4f}"
                for split in logs))
        log(f"  {CLI_EPOCHS} epochs in {t_cli:.1f} s (set-up included); launches {cli_counts}")
        # the host's share of an epoch: the metrics over one split's predictions
        from chromegcn_tpu_torch.utils.evals import compute_metrics

        rng = np.random.default_rng(1)
        for split, (_, n, _, _) in CLI_SPLITS.items():
            preds = rng.random((n, NCLASS), dtype=np.float32)
            targs = (rng.random((n, NCLASS)) < 0.05).astype(np.float32)
            t0 = time.perf_counter()
            compute_metrics(preds, targs, 0.0)
            log(f"  host compute_metrics over {split}'s {n} x {NCLASS} predictions: "
                f"{time.perf_counter() - t0:.1f} s")
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
    # in turns, 5 loops each: median (min-max) ms per call
    t = t_b1 = cuda_ms({
        "fwd": lambda: bsr_matmul(op.fwd, x),
        "bwd": lambda: bsr_matmul(op.bwd, x),
        "plain": lambda: bsr_matmul_plain(op.fwd, x),
        "library": lambda: torch.sparse.mm(adj_csr, x),
    })
    t_fwd, t_plain, t_lib = (statistics.median(t[k]) for k in ("fwd", "plain", "library"))
    b_ms, b_by, b_bytes, b_flops = bound(op.fwd, D)
    log(f"  B1 f32 d=128 ms/launch, median (min-max) of 5 loops of 20 in turns: "
        f"fwd {spread(t['fwd'])}; bwd {spread(t['bwd'])}; plain {spread(t['plain'])}; "
        f"torch.sparse.mm CSR {spread(t['library'])}")
    shares = {"B1 f32 d=128": b_ms / t_fwd}
    log(f"  bound {b_ms:.4f} ms by {b_by} ({b_bytes / 1e6:.1f} MB: {op.fwd.nnz} nonzeros' "
        f"values and columns, row pointers, x and out; {b_flops / 1e9:.4f} GFLOP); kernel at "
        f"{100 * shares['B1 f32 d=128']:.1f}% of it, torch.sparse.mm at {100 * b_ms / t_lib:.1f}%")
    log(f"  block form (not the bound): {elems} live block elements, "
        f"{block_bytes / 1e6:.1f} MB with their indices, for {ne} edges")
    dev_b1 = {d: device_ms(lambda: bsr_matmul(op.fwd, xd), "bsr_spmm_kernel")
              for d, xd in ((D, x), (1850, randn(N_PAD, 1850)))}
    log(f"  B1 f32 fwd device time per launch (torch.profiler, 20 launches): d=128 "
        f"{dev_b1[D]:.4f} ms, d=1850 {dev_b1[1850]:.4f} ms")
    for key, d in (("f32", 2 * D), ("bf16", D), ("bf16", 2 * D), ("hub", D), ("f32", 1850),
                   ("f32", 925)):
        m = ops[key].fwd
        xd = randn(N_PAD, d)
        tk = cuda_ms({key: lambda: bsr_matmul(m, xd)})[key]
        bm, by, _, _ = bound(m, d)
        shares[f"B1 {key} d={d}"] = bm / statistics.median(tk)
        log(f"  B1 fwd {key} d={d}: {spread(tk)} ms/launch; bound {bm:.4f} ms by {by} "
            f"({100 * shares[f'B1 {key} d={d}']:.1f}%)")
    del xd

    # B2 and B3 at the main path's shapes; the yardstick composes
    # torch.sparse.mm (CSR) with the epilogue's ops, as no single call does both
    ds, dx_dir = randn(N_PAD, D), randn(N_PAD, D)
    adj_t_csr = csr_of(graph, transpose=True)
    h_f = bsr_matmul(op.fwd, x)  # B2's h: B1 over op.fwd is the same gather
    h_t = bsr_matmul(op.bwd, ds)  # B3's h, over op.bwd
    compare("library tanh(sparse.mm(A, x) @ w + b) vs B2",
            torch.tanh(torch.sparse.mm(adj_csr, x) @ w + b), fused_fwd(op.fwd, x, w, b))
    t = cuda_ms({
        "B2": lambda: fused_fwd(op.fwd, x, w, b),
        "B2 plain": lambda: fused_fwd_plain(op.fwd, x, w, b),
        "B2 library": lambda: torch.tanh(torch.sparse.mm(adj_csr, x) @ w + b),
        "B2 epilogue GEMM": lambda: torch.tanh(torch.addmm(b, h_f, w)),
        "B3": lambda: fused_bwd(op.bwd, ds, dx_dir, w),
        "B3 plain": lambda: fused_bwd_plain(op.bwd, ds, dx_dir, w),
        "B3 library": lambda: torch.addmm(dx_dir, torch.sparse.mm(adj_t_csr, ds), w.T),
        "B3 epilogue GEMM": lambda: torch.addmm(dx_dir, h_t, w.T),
    })
    fused_rows = {}
    for kernel, key, m, bwd in (("gcn_fused_fwd", "B2", op.fwd, False),
                                ("gcn_fused_bwd", "B3", op.bwd, True)):
        ms, ms_plain, ms_lib = (statistics.median(t[k]) for k in (key, f"{key} plain",
                                                                   f"{key} library"))
        fb_ms, fb_by, fb_bytes, fb_flops = fused_bound(m, D, bwd)
        ffma_ms, ffma_by, _, _ = fused_bound(m, D, bwd, epi_rate=PEAK_FLOPS[torch.float32])
        fused_rows[kernel] = (ms, ms_plain, ms_lib, fb_ms, fb_by)
        shares[key] = fb_ms / ms
        log(f"  {key} f32 d=128 ms/launch, median (min-max) of 5 loops of 20 in turns: "
            f"kernel {spread(t[key])}; plain {spread(t[f'{key} plain'])}; library "
            f"composition {spread(t[f'{key} library'])}; bound {fb_ms:.4f} ms by {fb_by} "
            f"({fb_bytes / 1e6:.1f} MB, {fb_flops / 1e9:.4f} GFLOP, the GEMM at 3xTF32's "
            f"{TF32X3_FLOPS / 1e12:.0f} TFLOP/s); kernel at {100 * shares[key]:.1f}% of it, "
            f"library composition at {100 * fb_ms / ms_lib:.1f}%; record, not the bound: "
            f"with the GEMM at f32 FFMA's 67 TFLOP/s it would read {ffma_ms:.4f} ms by "
            f"{ffma_by}")
    log(f"  device time per launch (torch.profiler, 20 launches): B2 "
        f"{device_ms(lambda: fused_fwd(op.fwd, x, w, b), 'gcn_fused_kernel'):.4f} ms, B3 "
        f"{device_ms(lambda: fused_bwd(op.bwd, ds, dx_dir, w), 'gcn_fused_bwd_kernel'):.4f} ms")
    for key, kind, direction, gemm in (
            ("B2", "fwd", "op.fwd", "torch.tanh(torch.addmm(b, h, w))"),
            ("B3", "bwd", "op.bwd", "torch.addmm(dx_dir, h, w.T)")):
        log(f"  {key}'s two halves apart: B1 over {direction} (the same gather, writes h) "
            f"{spread(t_b1[kind])}; the epilogue in cuBLAS, {gemm} in f32, "
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
        "the same weights, in the f32 parity mode (TF32 and cuDNN off). Eval forward of 8 "
        "sequences in f32 within 1e-4 of its scale of the CPU's. One train step on 4 (dropout "
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
        names = [n for n, _ in states["card"].model.named_parameters()]
        # Expecto's gradients below bn3 pass back through train-mode BatchNorms
        # over near-constant ReLU'd channels: ill-conditioned in f32 on any
        # device (up to ~1e-1 of scale from float64 there, which this phase
        # reports); the float64 comparison holds them
        first_held = names.index("model.bn3.weight") if name == "expecto" else 0
        for i, (pname, pg, p64g, p64) in enumerate(zip(
                names, states["card"].model.parameters(), states["card64"].model.parameters(),
                states["cpu64"].model.parameters())):
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
        p64 = dict(states["cpu64"].model.named_parameters())
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
                   for n, pg in st.model.named_parameters()][first_held:]
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
            pipe_counts[mode] = dict(_build.LAUNCHES)
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

    # ---- 14. result ----
    kernels = [{
        "name": "bsr_spmm",
        "route": "cuda",
        "source": "chromegcn_tpu_torch/csrc/bsr_spmm.cu",
        "replaces": "chromegcn_tpu/ops/spmm_pallas.py:289",
        "launches": launches["bsr_spmm"],
        "max_abs_err": max(v for k, v in errs.items() if k != "library"),
        "ms": t_fwd,
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
        "max_abs_err": max(errs_fused[kernel]),
        "ms": fused_rows[kernel][0],
        "plain_ms": fused_rows[kernel][1],
        "bound_ms": fused_rows[kernel][3],
        "bound_by": fused_rows[kernel][4],
        "library_ms": fused_rows[kernel][2],
    } for kernel, source, replaces in (
        ("gcn_fused_fwd", "chromegcn_tpu_torch/csrc/gcn_fused.cu",
         "chromegcn_tpu/ops/gcn_fused.py:85"),
        ("gcn_fused_bwd", "chromegcn_tpu_torch/csrc/gcn_fused_bwd.cu",
         "chromegcn_tpu/ops/gcn_fused.py:206"))]
    log(f"[14 done] in {time.perf_counter() - t_start:.1f} s")
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
