"""FASTA access (port of chromegcn_tpu/pipeline/genome.py: ``Fasta`` and
``write_fasta``; a copy, since importing the JAX package imports jax).

``Fasta`` replaces bedtools getfasta for the variant pipeline
(pipeline/variants.py): a per-contig offset index built on open, random
access by seek.
"""

from __future__ import annotations

from typing import Dict, Tuple


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
