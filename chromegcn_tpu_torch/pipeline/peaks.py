"""Peak ingestion and window labeling (port of chromegcn_tpu/pipeline/peaks.py).

Replaces reference pipeline steps 2-3: the narrowPeak union
(data/2create_peaks.py:12-149) and the bedtools window x peak intersection
(data/3create_windows_with_peaks.py:39-55, `-wa -wb -f 0.1`).
"""

from __future__ import annotations

import glob
import gzip
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from chromegcn_tpu_torch import native_bridge


def read_narrowpeak(path: str, assay: str = None) -> Dict[str, np.ndarray]:
    """Read a (possibly gzipped) ENCODE narrowPeak bed file.

    Returns dict with 'chrom', 'start', 'end', 'assay' arrays. The assay
    label defaults to the filename stem — the reference uses the assay/file
    name as the label id (reference: data/2create_peaks.py).
    """
    if assay is None:
        assay = os.path.basename(path)
        for suffix in (".gz", ".narrowPeak", ".bed"):
            if assay.endswith(suffix):
                assay = assay[: -len(suffix)]
        assay = assay.lower()
    opener = gzip.open if path.endswith(".gz") else open
    chroms: List[str] = []
    starts: List[int] = []
    ends: List[int] = []
    with opener(path, "rt") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            chroms.append(parts[0])
            starts.append(int(parts[1]))
            ends.append(int(parts[2]))
    return {
        "chrom": np.asarray(chroms, dtype=object),
        "start": np.asarray(starts, dtype=np.int64),
        "end": np.asarray(ends, dtype=np.int64),
        "assay": assay,
    }


def collect_peak_files(peak_dir: str) -> List[str]:
    files = sorted(
        glob.glob(os.path.join(peak_dir, "*.narrowPeak"))
        + glob.glob(os.path.join(peak_dir, "*.narrowPeak.gz"))
        + glob.glob(os.path.join(peak_dir, "*.bed"))
        + glob.glob(os.path.join(peak_dir, "*.bed.gz"))
    )
    return files


def label_windows(
    win_starts: np.ndarray,
    win_ends: np.ndarray,
    peak_sets: Sequence[Dict[str, np.ndarray]],
    chrom: str,
    min_frac: float = 0.1,
) -> Tuple[np.ndarray, List[str]]:
    """Binary label matrix (n_windows x n_assays) for one chromosome.

    A window is positive for an assay when any peak overlaps >= min_frac of
    the window (bedtools -f 0.1 semantics via the native intersector).
    """
    assays = [ps["assay"] for ps in peak_sets]
    labels = np.zeros((len(win_starts), len(assays)), dtype=np.uint8)
    for a, ps in enumerate(peak_sets):
        sel = ps["chrom"] == chrom
        if not sel.any():
            continue
        w_idx, _ = native_bridge.intersect_fraction(
            win_starts, win_ends, ps["start"][sel], ps["end"][sel], min_frac
        )
        labels[np.unique(w_idx), a] = 1
    return labels, assays
