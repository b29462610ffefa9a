"""HiChIP allValidPairs → per-chromosome 1kb contact lists (port of
chromegcn_tpu/pipeline/hichip.py).

Reproduces the reference's HiChIP contact extraction
(reference: data/eqtl_data/HiChIP.py): parse a HiC-Pro allValidPairs TSV
(read name / chr1 / pos1 / strand1 / chr2 / pos2 / strand2 / fragment size
[/ allele tag]), keep intra-chromosomal pairs, round both positions to the
nearest 1 kb (Python banker's rounding — ``round(pos, -3)``, preserved
exactly), and keep pairs whose rounded distance exceeds 10 bp (i.e. the
two reads land in different 1 kb bins). Per-chromosome outputs are
(pos1, pos2, distance) rows, the format the reference feeds into its
eQTL graph construction.

The aggregated form (``hichip_edges``) returns (bin1, bin2, count) arrays
ready for pipeline.hic.chrom_topk_edges-style top-k graph building.
"""

from __future__ import annotations

import csv
import os
from collections import Counter
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

ALL_VALID_PAIRS_FIELDS = (
    "read_name", "chr_reads1", "pos_reads1", "strand_reads1",
    "chr_reads2", "pos_reads2", "strand_reads2", "fragment_size",
    "allele_specific_tag",
)
# reference HiChIP.py:20 — rounded-position distance must exceed this
MIN_DISTANCE = 10


def iter_intra_contacts(path: str) -> Iterator[Tuple[str, int, int, int]]:
    """Yield (chrom, pos1_1kb, pos2_1kb, distance) for qualifying pairs.

    Malformed rows (missing position fields) are skipped, matching the
    reference's try/except-and-continue (HiChIP.py:24-26).
    """
    with open(path, newline="") as f:
        reader = csv.DictReader(f, fieldnames=list(ALL_VALID_PAIRS_FIELDS),
                                delimiter="\t")
        for row in reader:
            if row["chr_reads1"] != row["chr_reads2"]:
                continue
            try:
                # banker's rounding to 1 kb, exactly the reference's
                # round(int(pos), -3) (HiChIP.py:14-15)
                p1 = int(round(int(row["pos_reads1"]), -3))
                p2 = int(round(int(row["pos_reads2"]), -3))
            except (TypeError, ValueError):
                continue
            dist = abs(p2 - p1)
            if dist > MIN_DISTANCE:
                yield row["chr_reads1"], p1, p2, dist


def extract_hichip_contacts(path: str, out_dir: str) -> Dict[str, int]:
    """Write per-chromosome ``<chrom>.allValidPairs`` TSVs of
    (pos1, pos2, distance) rows; returns contact counts per chromosome.

    Matches the reference's output contract (HiChIP.py:21-23) but streams
    through per-chrom writers instead of reopening the file per row.
    """
    os.makedirs(out_dir, exist_ok=True)
    writers: Dict[str, csv.writer] = {}
    handles = {}
    counts: Dict[str, int] = Counter()
    try:
        for chrom, p1, p2, dist in iter_intra_contacts(path):
            if chrom not in writers:
                handles[chrom] = open(
                    os.path.join(out_dir, f"{chrom}.allValidPairs"), "w",
                    newline="",
                )
                writers[chrom] = csv.writer(handles[chrom], delimiter="\t")
            writers[chrom].writerow([p1, p2, dist])
            counts[chrom] += 1
    finally:
        for h in handles.values():
            h.close()
    return dict(counts)


def hichip_edges(
    path: str,
    chrom: str,
    resolution: int = 1000,
    max_dist_bp: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Aggregate one chromosome's qualifying pairs into
    (bin1, bin2, count) arrays (bins = rounded position // resolution),
    the contact-matrix form pipeline.hic's top-k graph builder consumes."""
    pair_counts: Counter = Counter()
    for c, p1, p2, dist in iter_intra_contacts(path):
        if c != chrom:
            continue
        if max_dist_bp is not None and dist > max_dist_bp:
            continue
        b1, b2 = p1 // resolution, p2 // resolution
        pair_counts[(min(b1, b2), max(b1, b2))] += 1
    if not pair_counts:
        z = np.zeros(0, np.int64)
        return z, z.copy(), np.zeros(0, np.float32)
    keys = sorted(pair_counts)
    b1 = np.asarray([k[0] for k in keys], np.int64)
    b2 = np.asarray([k[1] for k in keys], np.int64)
    cnt = np.asarray([pair_counts[k] for k in keys], np.float32)
    return b1, b2, cnt
