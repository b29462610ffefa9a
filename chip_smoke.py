#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (chromegcn_tpu_torch).

Run from the repository root on a machine with one CUDA card (built for an
H100, sm_90a):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``chromegcn_tpu_torch/csrc`` (one nvcc
per source, started together) and drives the port only (no JAX), one line
per phase:

1. the card (nvidia-smi name and power limit) and torch/CUDA versions;
2. the kernel builds, with nvcc's register/spill report;
3. kernel B1 (bsr_spmm, a row gather over each direction's edge form)
   against its plain PyTorch version on the card: the chr1-scale bench
   graph's forward and transposed directions at d 128 and 256, f32 and bf16,
   tile 256 with an integer threshold, an all-strips tiling, a hub graph
   (hubness 0.5, rows of up to ~170 entries), and small graphs against a
   dense float64 product, one of them with a row of 1,500 entries; and that
   each edge form holds exactly its blocks' nonzeros;
4. the SpmmBSR gradient against the plain version's autograd;
5. the unfused main path at bench.py's full width (N_PAD 50,176, d 128, 919
   classes, 2 layers, 2 strands, SGD lr 0.25): one kernel-path train step
   against one step of the plain COO path from the same weights, then
   5 train steps with dropout 0.2 and one eval step, counting kernel
   launches (8 B1 per train step, 4 per eval step);
6. kernels B2 (gcn_fused) and B3 (gcn_fused_bwd) against their plain
   versions: the bench graph at d 128, f32 and bf16, B3 also on the hub
   graph and at d 192, and small graphs with an empty range of row blocks
   at d 32 for every tile height B2 is built for, and B3 at the widest
   width the fused layer admits, against a dense float64 product;
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
   B2/B3); each kernel's share of its bound (what the data needs: the edge
   list, the dense arrays, 2 nnz d operations plus the epilogue GEMM); the
   train and eval steps, unfused and fused, on the host clock;
11. a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Any failed phase ends the run with a non-zero exit code.

``python3 chip_smoke.py --profile`` adds to phase 10 a torch.profiler trace
of 3 train steps of each path: device time per step by kernel, and the
device's idle share of the step.
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
# kernel vs plain version: f32 sums of the same products in another order
ATOL, RTOL = 1e-5, 1e-5
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


def fused_bound(m, d, bwd):
    """Least time (ms) for one B2 (``bwd`` False: read x, w, b, write z) or
    B3 (read ds, dx_dir, w, write h and dx) launch over ``m``: the product's
    bytes and operations as ``bound``, plus the other dense arrays and the
    epilogue GEMM (2 n_rows d^2 f32 operations). Returns (ms, 'bytes' or
    'operations', bytes, operations)."""
    _, _, nbytes, stream_flops = bound(m, d)
    nbytes += 4 * (d * d + m.n_rows * d * (2 if bwd else 0) + (0 if bwd else d))
    epi_flops = 2 * m.n_rows * d * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (stream_flops / PEAK_FLOPS[m.val.dtype] + epi_flops / PEAK_FLOPS[torch.float32]) * 1e3
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


def profile_steps(step, t_step_ms, steps=3):
    """Device time per step by kernel over ``steps`` calls of ``step``, and
    the device's idle share of ``t_step_ms`` (a step timed without the
    profiler)."""
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
    groups = {}
    for ms, key, count in rows:
        name = key.lower()
        group = next((g for g, words in PROFILE_GROUPS if any(w in name for w in words)),
                     "other")
        t, n = groups.get(group, (0.0, 0))
        groups[group] = (t + ms, n + count)
    for group, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"    {group}: {ms:.4f} ms/step ({100 * ms / busy:.1f}%), {count} launches/step")
    for ms, key, count in rows[:12]:
        log(f"    {ms:9.4f} ms/step {100 * ms / busy:5.1f}%  x{count:<4} {key[:90]}")


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
    fused_lib = gcn_fused._kernel_lib()
    for tile, d in ((32, 32), (64, 128), (128, 128), (128, 192)):
        require(fused_lib.gcn_fused_smem_bytes(tile, d) == gcn_fused.smem_bytes(tile, d),
                f"fused_fits' shared-memory plan differs from the kernel's at tile {tile}, d {d}")
    # B3's own plan fits at every (tile, d) fused_fits admits, and is the
    # plan its wrapper checks
    bwd_lib = gcn_fused._bwd_kernel_lib()
    admitted = {tile: [d for d in range(4, 4097, 4)
                       if gcn_fused.smem_bytes(tile, d) <= gcn_fused.SMEM_LIMIT]
                for tile in gcn_fused.FUSED_TILE_ROWS}
    widest = max(max(ds) for ds in admitted.values())
    for tile, widths in admitted.items():
        for d in widths:
            plan = bwd_lib.gcn_fused_bwd_smem_bytes(d)
            require(plan == gcn_fused.bwd_smem_bytes(d) <= gcn_fused.SMEM_LIMIT,
                    f"B3's plan at tile {tile}, d {d} ({plan} bytes) does not fit")
    log(f"  B3 plan fits every width fused_fits admits: d <= "
        f"{', '.join(f'{max(w)} at tile {t}' for t, w in admitted.items())}; "
        f"{gcn_fused.bwd_smem_bytes(widest)} bytes at d {widest}")

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
    log("[6 B2/B3 vs plain] bench graph d=128 (f32, bf16); B3 on the hub graph and at "
        "d=192; dense 1024 graphs with an empty range of row blocks, d=32, and B3 at the "
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
    # B3 over the hub graph's rows of up to ~170 entries, and at d 192 (the
    # widest tile 128 admits)
    for key, d in (("hub", D), ("f32", 192)):
        m = ops[key].bwd
        ds, dx_dir = randn(N_PAD, d), randn(N_PAD, d)
        wd = randn(d, d) / d ** 0.5
        h_ref, dx_ref = fused_bwd_plain(m, ds, dx_dir, wd)
        poison_allocator((2 * N_PAD, d))
        h, dx = fused_bwd(m, ds, dx_dir, wd)
        errs_fused["gcn_fused_bwd"].append(compare(f"B3 {key} d={d} h", h, h_ref))
        errs_fused["gcn_fused_bwd"].append(compare(f"B3 {key} d={d} dx (atol of scale)", dx,
                                                   dx_ref, scaled=True))
    del ds, dx_dir, h, dx, h_ref, dx_ref
    # rows and columns 512-639 hold no edge: every tile height leaves at least
    # one row block empty in both directions (z = tanh(b), h = 0, dx = dx_dir)
    for tile in gcn_fused.FUSED_TILE_ROWS:
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
    # B3 at the widest width the fused layer admits (the smallest CTA rows)
    d = widest
    ds, dx_dir, ws = randn(1024, d), randn(1024, d), randn(d, d) / d ** 0.5
    h64 = a64.T @ ds.double()
    poison_allocator((2 * 1024, d))
    h, dx = fused_bwd(o.bwd, ds, dx_dir, ws)
    errs_fused["gcn_fused_bwd"].append(compare(f"B3 dense d={d} h vs float64", h, h64.float()))
    # atol of the summed terms' magnitude: each dx entry sums 1,344 products
    # in f32, whose rounding grows with the terms, not with the result
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
    for key, d in (("f32", 2 * D), ("bf16", D), ("bf16", 2 * D), ("hub", D)):
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
    h_t = bsr_matmul(op.bwd, ds)  # B3's h: B1 over op.bwd is the same gather
    compare("library tanh(sparse.mm(A, x) @ w + b) vs B2",
            torch.tanh(torch.sparse.mm(adj_csr, x) @ w + b), fused_fwd(op.fwd, x, w, b))
    t = cuda_ms({
        "B2": lambda: fused_fwd(op.fwd, x, w, b),
        "B2 plain": lambda: fused_fwd_plain(op.fwd, x, w, b),
        "B2 library": lambda: torch.tanh(torch.sparse.mm(adj_csr, x) @ w + b),
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
        fused_rows[kernel] = (ms, ms_plain, ms_lib, fb_ms, fb_by)
        shares[key] = fb_ms / ms
        log(f"  {key} f32 d=128 ms/launch, median (min-max) of 5 loops of 20 in turns: "
            f"kernel {spread(t[key])}; plain {spread(t[f'{key} plain'])}; library "
            f"composition {spread(t[f'{key} library'])}; bound {fb_ms:.4f} ms by {fb_by} "
            f"({fb_bytes / 1e6:.1f} MB, {fb_flops / 1e9:.4f} GFLOP); kernel at "
            f"{100 * shares[key]:.1f}% of it, library composition at "
            f"{100 * fb_ms / ms_lib:.1f}%")
    log(f"  B3's two halves apart: B1 over op.bwd (the same gather, writes h) "
        f"{spread(t_b1['bwd'])}; the epilogue as one cuBLAS call, "
        f"torch.addmm(dx_dir, h, w.T) in f32, {spread(t['B3 epilogue GEMM'])}")
    del x, ds, dx_dir, h_t
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

    # ---- 11. result ----
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
    log(f"[11 done] in {time.perf_counter() - t_start:.1f} s")
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
