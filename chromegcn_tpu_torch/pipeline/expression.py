"""Expression-label and eQTL/HiChIP utilities (port of
chromegcn_tpu/pipeline/expression.py).

Replaces the reference's auxiliary label pipelines:
- roadmap expression -> narrowPeak-like bed rows for expressed genes
  (reference: data/extras/create_expr_bed.py)
- eQTL expression thresholding (mean/median across samples) and TSS
  annotation for the HCASMC dataset (reference: data/eqtl_data/
  eqtl_process{_mean,_median}.py, eQTL_hg19Encode_TSS_annotation.py)
- HiChIP contact extraction lives in pipeline/hichip.py (allValidPairs
  reader -> per-chrom 1kb contacts; reference: data/eqtl_data/HiChIP.py),
  whose binned output feeds the same top-k graph construction as Hi-C
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def threshold_expression(
    values: np.ndarray, method: str = "median"
) -> np.ndarray:
    """Binary expressed/not-expressed labels per gene.

    values: (n_genes, n_samples) expression matrix. A gene is 'expressed'
    when its aggregate across samples exceeds the aggregate's own
    across-gene median (reference thresholds per-gene summaries this way in
    eqtl_process_{mean,median}.py).
    """
    values = np.asarray(values, dtype=np.float64)
    if method == "median":
        per_gene = np.median(values, axis=1)
    elif method == "mean":
        per_gene = values.mean(axis=1)
    else:
        raise ValueError("method must be 'median' or 'mean'")
    return (per_gene > np.median(per_gene)).astype(np.uint8)


def expression_to_bed(
    genes: Sequence[Tuple[str, int, int, str]],
    expressed: np.ndarray,
    assay: str = "expr",
) -> List[Tuple[str, int, int, str]]:
    """narrowPeak-like rows (chrom, start, end, name) for expressed genes
    (reference: data/extras/create_expr_bed.py emits expressed-gene bed)."""
    rows = []
    for (chrom, start, end, name), flag in zip(genes, expressed):
        if flag:
            rows.append((chrom, start, end, f"{assay}_{name}"))
    return rows


def annotate_tss(
    gene_starts: np.ndarray,
    gene_strands: np.ndarray,
    gene_ends: Optional[np.ndarray] = None,
) -> np.ndarray:
    """TSS position per gene: start for +, end for - strand
    (reference: eQTL_hg19Encode_TSS_annotation.py)."""
    gene_starts = np.asarray(gene_starts, np.int64)
    if gene_ends is None:
        return gene_starts
    gene_ends = np.asarray(gene_ends, np.int64)
    minus = np.asarray([s == "-" for s in gene_strands])
    return np.where(minus, gene_ends, gene_starts)


def window_of(positions: np.ndarray, window: int = 1000) -> np.ndarray:
    """Assign genomic positions to window start coordinates."""
    return (np.asarray(positions, np.int64) // window) * window


def tss_window_labels(
    window_starts: np.ndarray,
    tss_positions: np.ndarray,
    expressed: np.ndarray,
    window: int = 1000,
) -> np.ndarray:
    """Per-window expressed-gene label: 1 if any expressed gene's TSS falls
    in the window."""
    window_starts = np.asarray(window_starts, np.int64)
    labels = np.zeros(len(window_starts), np.uint8)
    idx = {int(w): i for i, w in enumerate(window_starts)}
    for pos, flag in zip(window_of(tss_positions, window), expressed):
        if flag and int(pos) in idx:
            labels[idx[int(pos)]] = 1
    return labels
