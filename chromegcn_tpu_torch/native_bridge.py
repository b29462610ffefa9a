"""ctypes bridge to the port's native ingest library (port of
chromegcn_tpu/native_bridge.py).

The library is the port's own ``native/chromegcn_native.cc``, a host C++
library with a plain C interface. It is compiled at first use by ``g++`` (or
``$CXX``) with the reference Makefile's flags into ``build/native/`` at the
repository root, and loaded with ctypes. Its file name carries a hash of the
source, the compiler and the flags, so an edited source or flag is rebuilt
and a stale build is never loaded. Nothing runs at import time.

There is no fallback: ``hic_topk`` and ``intersect_fraction`` run the
library, or raise with the compiler's message when it cannot be built. The
numpy versions, ``hic_topk_plain`` and ``intersect_fraction_plain``, are the
library's oracles for the tests and ``chip_smoke.py``; nothing on the ingest
path calls them. The reference returns its numpy path whenever its library
fails to build or load.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "chromegcn_native.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "native"
# the reference's chromegcn_tpu/native/Makefile: CXXFLAGS and -shared
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lib: Optional[ctypes.CDLL] = None


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    """The library's path, keyed on a hash of the source, the compiler and
    CXXFLAGS."""
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update("\0".join((compiler(),) + CXXFLAGS).encode())
    return BUILD_DIR / f"libchromegcn_native-{h.hexdigest()[:12]}.so"


def build() -> Optional[str]:
    """Compile the library; returns the compiler's output, or None if it was
    already built. Raises RuntimeError if it cannot be built."""
    out = library_path()
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler(), *CXXFLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native ingest library build failed: {' '.join(cmd)}: {e}") from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native ingest library build failed: {' '.join(cmd)} exited "
                           f"{proc.returncode}\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return log


def load() -> ctypes.CDLL:
    """The library, built first if needed (cached)."""
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(str(library_path()))
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.hic_topk.restype = ctypes.c_int64
    lib.hic_topk.argtypes = [
        ctypes.c_char_p, f64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        i64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p, f64p,
        ctypes.c_int64,
    ]
    lib.intersect_fraction.restype = ctypes.c_int64
    lib.intersect_fraction.argtypes = [
        i64p, i64p, ctypes.c_int64, i64p, i64p, ctypes.c_int64,
        ctypes.c_double, i64p, i64p, ctypes.c_int64,
    ]
    _lib = lib
    return lib


def _as_i64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def hic_topk(
    path: str,
    bins: np.ndarray,
    k: int,
    norm: Optional[np.ndarray] = None,
    resolution_bp: int = 1000,
    min_dist_bp: int = 0,
    max_dist_bp: Optional[int] = None,
    upsample_grid: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Top-k normalized Hi-C contacts among ``bins`` from a RAWobserved file.

    Returns (bin1, bin2, val) descending by val (top contact first). Semantics match the
    reference's get_contact_edge_pairs + get_top_contact_locs
    (reference: data/7create_graph_new.py:66-116): self-contacts skipped,
    both endpoints must be peak-window bins, normalization divides by
    norm[bin/resolution] with 0/NaN meaning "discard". On a tie at the k-th
    value the contact seen first is kept.

    min_dist_bp/max_dist_bp filter by genomic distance DURING streaming —
    before top-k selection, so the k best contacts are chosen among the
    qualifying ones. min_dist_bp reproduces the old graph builder's
    min_distance_threshold (reference: data/7create_graph_old.py:166, the
    "min1000" in its artifact names); max_dist_bp is this framework's
    extension (None disables).

    upsample_grid > 1 expands each streamed coarse contact onto the
    grid x grid fine-resolution offsets IN the stream (the K562 5kb -> 1kb
    flow, reference: data/extras/upsample_hic.py:25-45) — no 25x
    intermediate dump is materialized.
    """
    bins = np.unique(_as_i64(bins))
    lib = load()
    out1 = np.empty(k, np.int64)
    out2 = np.empty(k, np.int64)
    outv = np.empty(k, np.float64)
    normp = None
    norm_len = 0
    if norm is not None:
        norm = np.ascontiguousarray(np.asarray(norm, dtype=np.float64))
        normp = _ptr(norm, ctypes.c_double)
        norm_len = len(norm)
    n = lib.hic_topk(
        path.encode(), normp, norm_len, resolution_bp,
        min_dist_bp, 0 if max_dist_bp is None else max_dist_bp,
        _ptr(bins, ctypes.c_int64), len(bins), k,
        _ptr(out1, ctypes.c_int64), _ptr(out2, ctypes.c_int64), _ptr(outv, ctypes.c_double),
        upsample_grid,
    )
    if n < 0:
        raise FileNotFoundError(f"hic_topk: cannot open {path}")
    return out1[:n], out2[:n], outv[:n]


def hic_topk_plain(path, bins, k, norm=None, resolution_bp=1000,
                   min_dist_bp=0, max_dist_bp=None, upsample_grid=1):
    """``hic_topk`` in numpy, chunked (the reference's fallback, exact). The
    same pairs and values as the library's; on a tie at the k-th value it
    may keep another contact, and it orders ties otherwise."""
    bins = np.unique(_as_i64(bins))
    bin_set = set(int(b) for b in bins)
    best1, best2, bestv = [], [], []
    chunk_b1, chunk_b2, chunk_v = [], [], []

    def flush():
        nonlocal best1, best2, bestv, chunk_b1, chunk_b2, chunk_v
        if not chunk_b1:
            return
        b1 = np.asarray(chunk_b1, np.int64)
        b2 = np.asarray(chunk_b2, np.int64)
        v = np.asarray(chunk_v, np.float64)
        chunk_b1, chunk_b2, chunk_v = [], [], []
        all1 = np.concatenate([np.asarray(best1, np.int64), b1])
        all2 = np.concatenate([np.asarray(best2, np.int64), b2])
        allv = np.concatenate([np.asarray(bestv, np.float64), v])
        if len(allv) > k:
            top = np.argpartition(allv, len(allv) - k)[-k:]
            all1, all2, allv = all1[top], all2[top], allv[top]
        best1, best2, bestv = all1.tolist(), all2.tolist(), allv.tolist()

    offsets = [
        (i * resolution_bp, j * resolution_bp)
        for i in range(max(upsample_grid, 1))
        for j in range(max(upsample_grid, 1))
    ]
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            rb1, rb2 = int(parts[0]), int(parts[1])
            rv = float(parts[2])
            # upsample_grid > 1: expand the coarse contact onto the fine
            # grid in-stream, filters applied per expanded contact (same
            # semantics as streaming a pre-upsampled file)
            for o1, o2 in offsets:
                b1, b2 = rb1 + o1, rb2 + o2
                dist = abs(b1 - b2)
                if dist < min_dist_bp or (max_dist_bp is not None and dist > max_dist_bp):
                    continue
                if b1 == b2 or b1 not in bin_set or b2 not in bin_set:
                    continue
                v = rv
                if norm is not None:
                    n1 = norm[b1 // resolution_bp] if b1 // resolution_bp < len(norm) else 0.0
                    n2 = norm[b2 // resolution_bp] if b2 // resolution_bp < len(norm) else 0.0
                    if n1 == 0 or n2 == 0 or np.isnan(n1) or np.isnan(n2):
                        continue
                    v = v / (n1 * n2)
                chunk_b1.append(b1)
                chunk_b2.append(b2)
                chunk_v.append(v)
            if len(chunk_b1) >= 1_000_000:
                flush()
    flush()
    order = np.argsort(np.asarray(bestv))[::-1]
    return (
        np.asarray(best1, np.int64)[order],
        np.asarray(best2, np.int64)[order],
        np.asarray(bestv, np.float64)[order],
    )


def intersect_fraction(
    win_start: np.ndarray,
    win_end: np.ndarray,
    peak_start: np.ndarray,
    peak_end: np.ndarray,
    min_frac: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """(window_idx, peak_idx) pairs where overlap >= min_frac * window length.

    bedtools `intersect -f` semantics (reference shells out at
    data/3create_windows_with_peaks.py:43). Windows must be sorted by start.
    Pairs come by window; one window's peaks in an order that ``std::sort``
    leaves unspecified among peaks with equal starts.
    """
    win_start = _as_i64(win_start)
    win_end = _as_i64(win_end)
    peak_start = _as_i64(peak_start)
    peak_end = _as_i64(peak_end)
    if not len(win_start) or not len(peak_start):
        return np.empty(0, np.int64), np.empty(0, np.int64)
    lib = load()
    cap = max(len(win_start) * 4, 1024)
    while True:
        out_w = np.empty(cap, np.int64)
        out_p = np.empty(cap, np.int64)
        n = lib.intersect_fraction(
            _ptr(win_start, ctypes.c_int64), _ptr(win_end, ctypes.c_int64), len(win_start),
            _ptr(peak_start, ctypes.c_int64), _ptr(peak_end, ctypes.c_int64), len(peak_start),
            min_frac, _ptr(out_w, ctypes.c_int64), _ptr(out_p, ctypes.c_int64), cap,
        )
        if n <= cap:
            return out_w[:n], out_p[:n]
        cap = int(n)


def intersect_fraction_plain(win_start, win_end, peak_start, peak_end, min_frac=0.1):
    """``intersect_fraction`` in numpy (the reference's fallback): the same
    pairs, one window's peaks in stable start order."""
    win_start = _as_i64(win_start)
    win_end = _as_i64(win_end)
    peak_start = _as_i64(peak_start)
    peak_end = _as_i64(peak_end)
    if len(win_start) == 0 or len(peak_start) == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    order = np.argsort(peak_start, kind="stable")
    ps, pe = peak_start[order], peak_end[order]
    max_len = int((pe - ps).max())
    out_w, out_p = [], []
    for w in range(len(win_start)):
        ws, we = int(win_start[w]), int(win_end[w])
        need = min_frac * (we - ws)
        lo = np.searchsorted(ps, ws - max_len)
        hi = np.searchsorted(ps, we)
        if hi <= lo:
            continue
        ov = np.minimum(we, pe[lo:hi]) - np.maximum(ws, ps[lo:hi])
        sel = np.nonzero((ov > 0) & (ov >= need))[0]
        for s in sel:
            out_w.append(w)
            out_p.append(int(order[lo + s]))
    return np.asarray(out_w, np.int64), np.asarray(out_p, np.int64)
