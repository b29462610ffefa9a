"""Synthetic RAW-FILE world generator: FASTA + narrowPeak + Juicer-style
Hi-C dumps, with planted, graph-coupled signal (port of
chromegcn_tpu/data/synthetic_raw.py: the same random stream in the same
order, so a seed writes byte-identical files).

This feeds the full product seam the reference documents — raw files ->
data pipeline -> artifacts -> CLI training (reference: README.md:31-46 run
commands over artifacts produced by data/create_data.py:14) — with inputs
whose ground truth is known, so an end-to-end run can verify both that the
pipeline composes and that training actually learns from files on disk.

Signal design (mirrors data/synthetic.make_graph_coupled_dataset, but
expressed as raw files):
- each assay a has a planted ``motif_len``-mer; window i "carries" assay
  a's motif with prob ``motif_p`` (the motif is written into the genome
  sequence inside the window);
- a per-chromosome contact graph is sampled with a heavy-tailed genomic
  distance profile; contacts become high-count RAWobserved lines (plus
  low-count background noise lines and a norm vector with a few discarded
  bins, exercising the pipeline's normalization/discard paths);
- TFBS/HM assays are GRAPH-COUPLED: the label fires iff the window carries
  the motif AND >= ``neighbor_thresh`` of its contact-graph neighbors carry
  it too (invisible to a sequence-only model); DNase assays are sequence-
  only (label == motif presence) so the CNN has clean learnable signal;
- labels are emitted as narrowPeak intervals inside the window, so the
  pipeline's peak-window intersection (-f 0.1 semantics) reconstructs them.

Assay file names follow the ENCODE naming convention the label-type
splitter keys on (utils/evals._label_type_indices; reference:
utils/evals.py:29-36): ``wgencodeawgtfbs...unipk``, ``e116-h...``,
``...dnase...``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from chromegcn_tpu_torch.pipeline.genome import HG19_SIZES

_BASES = np.frombuffer(b"acgt", dtype=np.uint8)


def _sample_contacts(
    n_win: int, n_pairs: int, rng: np.random.Generator, power: float = 1.5
) -> Tuple[np.ndarray, np.ndarray]:
    """Undirected unique contact pairs (i < j) with short-range-dominated
    distances (like real Hi-C; same profile as synthetic.make_hic_edges)."""
    i = rng.integers(0, n_win, size=n_pairs * 2)
    dist = np.maximum(1, (rng.pareto(power, size=n_pairs * 2) * 3).astype(np.int64))
    j = i + np.where(rng.random(n_pairs * 2) < 0.5, dist, -dist)
    ok = (j >= 0) & (j < n_win) & (j != i)
    i, j = i[ok], j[ok]
    lo, hi = np.minimum(i, j), np.maximum(i, j)
    key = lo * n_win + hi
    _, first = np.unique(key, return_index=True)
    first = first[:n_pairs]
    return lo[first].astype(np.int64), hi[first].astype(np.int64)


def default_assays(n_tfbs: int = 6, n_hm: int = 3, n_dnase: int = 3):
    """(file_stem, coupled) per assay, ENCODE-convention names."""
    assays = []
    for t in range(n_tfbs):
        assays.append((f"wgEncodeAwgTfbsGm12878Tf{t:02d}UniPk", True))
    for h in range(n_hm):
        assays.append((f"E116-H3K{4 + h}me3", True))
    for d in range(n_dnase):
        assays.append((f"Gm12878Dnase{d:02d}", False))
    return assays


def make_raw_world(
    out_dir: str,
    chrom_sizes: Dict[str, int],
    n_tfbs: int = 6,
    n_hm: int = 3,
    n_dnase: int = 3,
    window: int = 1000,
    motif_len: int = 8,
    motif_p: float = 0.18,
    neighbor_thresh: float = 0.3,
    pairs_per_node: float = 6.0,
    noise_frac: float = 1.0,
    hicnorm: str = "SQRTVC",
    fasta_line: int = 80,
    seed: int = 0,
    verbose=print,
) -> Dict[str, object]:
    """Write genome.fa, peaks/*.narrowPeak, hic/{chrom}.RAWobserved +
    .{hicnorm}norm under ``out_dir``. Returns ground-truth stats."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "peaks"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "hic"), exist_ok=True)

    assays = default_assays(n_tfbs, n_hm, n_dnase)
    n_assays = len(assays)
    coupled = np.asarray([c for _, c in assays])
    motifs = rng.integers(0, 4, size=(n_assays, motif_len)).astype(np.uint8)

    peak_lines: Dict[str, list] = {stem: [] for stem, _ in assays}
    stats = {"chroms": {}, "n_assays": n_assays, "window": window}
    fa_path = os.path.join(out_dir, "genome.fa")
    fa = open(fa_path, "wb")
    try:
        for chrom, size in chrom_sizes.items():
            crng = np.random.default_rng(rng.integers(1 << 62))
            n_win = size // window
            seq = crng.integers(0, 4, size=size).astype(np.uint8)

            # motif presence + planted motifs (assay a sits at a fixed
            # per-assay offset inside the 1kb window so motifs never collide)
            present = crng.random((n_win, n_assays)) < motif_p
            for a in range(n_assays):
                rows = np.nonzero(present[:, a])[0]
                base = rows * window + 100 + a * (motif_len + 4)
                for o in range(motif_len):
                    seq[base + o] = motifs[a, o]

            # contact graph + neighbor motif fractions
            n_pairs = int(n_win * pairs_per_node)
            ci, cj = _sample_contacts(n_win, n_pairs, crng)
            s = np.concatenate([ci, cj])
            r = np.concatenate([cj, ci])
            deg = np.maximum(np.bincount(r, minlength=n_win), 1)
            nbr = np.zeros((n_win, n_assays), np.float32)
            np.add.at(nbr, r, present[s].astype(np.float32))
            nbr /= deg[:, None]

            labels = present & np.where(
                coupled[None, :], nbr >= neighbor_thresh, True
            )

            # peaks: one 240bp interval inside the window per positive label
            for a, (stem, _) in enumerate(assays):
                rows = np.nonzero(labels[:, a])[0]
                starts = rows * window + 80
                peak_lines[stem].extend(
                    f"{chrom}\t{st}\t{st + 240}\t.\t0\t.\t0\t-1\t-1\t-1"
                    for st in starts
                )

            # FASTA body
            fa.write(f">{chrom}\n".encode())
            byts = _BASES[seq]
            for off in range(0, size, fasta_line):
                fa.write(byts[off : off + fasta_line].tobytes())
                fa.write(b"\n")

            # Hi-C: signal contacts high-count, noise low-count, shuffled
            sig_count = crng.integers(20, 81, size=len(ci))
            n_noise = int(noise_frac * len(ci))
            nzi, nzj = _sample_contacts(n_win, n_noise, crng)
            noise_count = crng.integers(1, 4, size=len(nzi))
            b1 = np.concatenate([ci, nzi]) * window
            b2 = np.concatenate([cj, nzj]) * window
            cnt = np.concatenate([sig_count, noise_count])
            perm = crng.permutation(len(b1))
            with open(
                os.path.join(out_dir, "hic", f"{chrom}.RAWobserved"), "w"
            ) as f:
                f.writelines(
                    f"{b1[p]}\t{b2[p]}\t{cnt[p]}\n" for p in perm
                )
            # norm vector ~1 with ~1% discarded bins (NaN), never on a
            # signal endpoint (discard-path coverage without signal loss)
            norm = crng.uniform(0.7, 1.3, size=n_win + 1)
            bad = crng.random(n_win + 1) < 0.01
            bad[np.unique(np.concatenate([ci, cj]))] = False
            with open(
                os.path.join(out_dir, "hic", f"{chrom}.{hicnorm}norm"), "w"
            ) as f:
                f.writelines(
                    "NaN\n" if bad[i] else f"{norm[i]:.6f}\n"
                    for i in range(n_win + 1)
                )

            kept = labels.any(axis=1)
            both_kept = int((kept[ci] & kept[cj]).sum())
            stats["chroms"][chrom] = {
                "size": int(size),
                "n_windows": int(n_win),
                "kept_windows": int(kept.sum()),
                "signal_pairs": int(len(ci)),
                "signal_pairs_both_kept": both_kept,
                "noise_pairs": int(len(nzi)),
                "positives": int(labels.sum()),
            }
            verbose(
                f"[raw] {chrom}: {n_win} windows, {int(kept.sum())} kept, "
                f"{len(ci)} signal pairs ({both_kept} both-kept)"
            )
    finally:
        fa.close()

    for stem, _ in assays:
        with open(os.path.join(out_dir, "peaks", f"{stem}.narrowPeak"), "w") as f:
            f.write("\n".join(peak_lines[stem]) + ("\n" if peak_lines[stem] else ""))

    stats["total_kept"] = int(
        sum(c["kept_windows"] for c in stats["chroms"].values())
    )
    stats["assays"] = [stem.lower() for stem, _ in assays]
    stats["coupled"] = coupled.tolist()
    with open(os.path.join(out_dir, "ground_truth.json"), "w") as f:
        json.dump(stats, f, indent=1)
    return stats


def scaled_hg19_sizes(scale: int = 60, floor: int = 1_200_000) -> Dict[str, int]:
    """All 22 chromosome sizes scaled down from hg19 (several node buckets
    on chr1 at scale=60: ~4.1M -> ~4.1k windows)."""
    return {c: max(floor, s // scale) for c, s in HG19_SIZES.items()}
