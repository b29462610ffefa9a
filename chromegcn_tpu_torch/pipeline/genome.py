"""Genome primitives: chromosome sizes, FASTA access, window tiling (port of
chromegcn_tpu/pipeline/genome.py; a copy, since importing the JAX package
imports jax).

Replaces reference data pipeline step 1 (data/1create_windows.py:12-63) and
the bedtools-getfasta sequence extraction of step 4 (data/4create_seqs.py:34)
with in-process equivalents. ``Fasta`` also serves the variant pipeline
(pipeline/variants.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# hg19 chromosome sizes (UCSC), chr1-22 — the reference operates on these
# (reference: data/create_data.py:40-43 chrom list).
HG19_SIZES: Dict[str, int] = {
    "chr1": 249250621, "chr2": 243199373, "chr3": 198022430, "chr4": 191154276,
    "chr5": 180915260, "chr6": 171115067, "chr7": 159138663, "chr8": 146364022,
    "chr9": 141213431, "chr10": 135534747, "chr11": 135006516, "chr12": 133851895,
    "chr13": 115169878, "chr14": 107349540, "chr15": 102531392, "chr16": 90354753,
    "chr17": 81195210, "chr18": 78077248, "chr19": 59128983, "chr20": 63025520,
    "chr21": 48129895, "chr22": 51304566,
}


def tile_windows(
    chrom_size: int, window: int = 1000
) -> Tuple[np.ndarray, np.ndarray]:
    """Tile a chromosome into fixed windows (start, end), dropping the ragged
    tail (reference: data/1create_windows.py tiles [0, size) in 1kb steps)."""
    n = chrom_size // window
    starts = np.arange(n, dtype=np.int64) * window
    return starts, starts + window


def extend_windows(
    starts: np.ndarray, ends: np.ndarray, flank: int, chrom_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """+-flank extension, clipped to chromosome bounds
    (reference: data/3create_windows_with_peaks.py extended windows +-500)."""
    return (
        np.maximum(starts - flank, 0),
        np.minimum(ends + flank, chrom_size),
    )


class Fasta:
    """Minimal indexed FASTA reader (replaces bedtools getfasta).

    Builds a per-contig offset index on open; random access via seek.
    Assumes uniform line length within each contig body (standard FASTA).
    """

    def __init__(self, path: str):
        self.path = path
        self._index: Dict[str, Tuple[int, int, int, int]] = {}
        self._build_index()

    def _build_index(self) -> None:
        with open(self.path, "rb") as f:
            name = None
            body_offset = 0
            line_len = 0
            line_bytes = 0
            length = 0
            pos = 0
            for raw in f:
                if raw.startswith(b">"):
                    if name is not None:
                        self._index[name] = (body_offset, length, line_len, line_bytes)
                    name = raw[1:].split()[0].decode()
                    body_offset = pos + len(raw)
                    length = 0
                    line_len = 0
                    line_bytes = 0
                else:
                    stripped = raw.rstrip(b"\r\n")
                    if line_len == 0:
                        line_len = len(stripped)
                        line_bytes = len(raw)
                    length += len(stripped)
                pos += len(raw)
            if name is not None:
                self._index[name] = (body_offset, length, line_len, line_bytes)

    def contigs(self) -> Dict[str, int]:
        return {name: info[1] for name, info in self._index.items()}

    def fetch(self, chrom: str, start: int, end: int) -> str:
        """0-based half-open interval sequence (lowercased)."""
        offset, length, line_len, line_bytes = self._index[chrom]
        start = max(0, start)
        end = min(end, length)
        if start >= end:
            return ""
        with open(self.path, "rb") as f:
            first_line = start // line_len
            first_col = start % line_len
            byte_start = offset + first_line * line_bytes + first_col
            last_line = (end - 1) // line_len
            byte_end = offset + last_line * line_bytes + ((end - 1) % line_len) + 1
            f.seek(byte_start)
            raw = f.read(byte_end - byte_start)
        return raw.replace(b"\n", b"").replace(b"\r", b"").decode().lower()


def write_fasta(path: str, contigs: Dict[str, str], line_len: int = 60) -> None:
    """Test/ingest helper to emit FASTA files."""
    with open(path, "w") as f:
        for name, seq in contigs.items():
            f.write(f">{name}\n")
            for i in range(0, len(seq), line_len):
                f.write(seq[i : i + line_len] + "\n")
