"""End-to-end dataset builder: FASTA + narrowPeaks + Hi-C -> npz artifacts
(port of chromegcn_tpu/pipeline/build.py; the files it writes equal the
reference's).

One entry point replacing reference steps 1-7 + create_torch_data
(data/create_data.py dispatch, data/1..7*.py, data/create_torch_data.py):

    from chromegcn_tpu_torch.pipeline.build import build_dataset
    build_dataset(fasta_path, peak_dir, out_dir, ...)

Contracts preserved:
- 1kb windows, +-500bp extension (reference: data/create_data.py:17-18)
- only windows containing >=1 peak are kept (reference: step 3)
- split by chromosome: valid chr3/12/17, test chr1/8/21
  (reference: data/create_data.py:44-45)
- per-split Hi-C graph dicts keyed by chromosome (reference: step 7)
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from chromegcn_tpu_torch.data import artifact
from chromegcn_tpu_torch.data.constants import (
    EXTENDED_WINDOW_SIZE,
    SRC_VOCAB,
    TEST_CHROMS,
    VALID_CHROMS,
    WINDOW_SIZE,
)
from chromegcn_tpu_torch.data.loader import WindowDataset
from chromegcn_tpu_torch.ops.seq import encode_sequence
from chromegcn_tpu_torch.pipeline import genome, hic, peaks


def split_of(chrom: str) -> str:
    if chrom in VALID_CHROMS:
        return "valid"
    if chrom in TEST_CHROMS:
        return "test"
    return "train"


def build_dataset(
    fasta_path: str,
    peak_dir: str,
    out_dir: str,
    chroms: Optional[Sequence[str]] = None,
    window: int = WINDOW_SIZE,
    extended: int = EXTENDED_WINDOW_SIZE,
    min_frac: float = 0.1,
    small_per_split: int = 0,
    verbose=print,
) -> Dict[str, WindowDataset]:
    """Build and save the windows dataset (dataset.npz) from raw inputs."""
    fa = genome.Fasta(fasta_path)
    contigs = fa.contigs()
    if chroms is None:
        chroms = [c for c in contigs if c.startswith("chr")]

    peak_files = peaks.collect_peak_files(peak_dir)
    if not peak_files:
        raise FileNotFoundError(f"no narrowPeak/bed files in {peak_dir}")
    peak_sets = [peaks.read_narrowpeak(p) for p in peak_files]
    assays = [ps["assay"] for ps in peak_sets]
    tgt_vocab = {a: i for i, a in enumerate(assays)}
    flank = (extended - window) // 2

    per_split: Dict[str, Dict[str, List]] = {
        s: {"tokens": [], "targets": [], "chroms": [], "starts": []}
        for s in ("train", "valid", "test")
    }

    for chrom in chroms:
        size = contigs[chrom]
        w_start, w_end = genome.tile_windows(size, window)
        labels, _ = peaks.label_windows(w_start, w_end, peak_sets, chrom, min_frac)
        keep = labels.any(axis=1)  # reference step 3: only windows with peaks
        w_start, w_end, labels = w_start[keep], w_end[keep], labels[keep]
        if len(w_start) == 0:
            continue
        e_start, e_end = genome.extend_windows(w_start, w_end, flank, size)
        toks = np.zeros((len(w_start), extended), np.int32)
        pad_id = SRC_VOCAB["n"]
        for i in range(len(w_start)):
            seq = fa.fetch(chrom, int(e_start[i]), int(e_end[i]))
            enc = encode_sequence(seq, SRC_VOCAB)
            if len(enc) < extended:  # clipped at chromosome edge; pad with n
                full = np.full(extended, pad_id, np.int32)
                full[: len(enc)] = enc
                enc = full
            toks[i] = enc[:extended]
        split = split_of(chrom)
        per_split[split]["tokens"].append(toks)
        per_split[split]["targets"].append(labels)
        per_split[split]["chroms"].extend([chrom] * len(w_start))
        per_split[split]["starts"].append(w_start)
        verbose(f"{chrom}: {len(w_start)} peak windows -> {split}")

    splits: Dict[str, WindowDataset] = {}
    for split, acc in per_split.items():
        if not acc["tokens"]:
            continue
        splits[split] = WindowDataset(
            tokens=np.concatenate(acc["tokens"]),
            targets=np.concatenate(acc["targets"]),
            chroms=np.asarray(acc["chroms"], dtype=object),
            starts=np.concatenate(acc["starts"]),
            src_vocab=dict(SRC_VOCAB),
            tgt_vocab=tgt_vocab,
        )

    os.makedirs(out_dir, exist_ok=True)
    artifact.save_dataset(os.path.join(out_dir, "dataset.npz"), splits)
    verbose(f"wrote {os.path.join(out_dir, 'dataset.npz')}")

    if small_per_split:
        # small-subset artifact for quick experiments (reference -small flag:
        # config_args.py:121-122 loads train_valid_test_small.pt)
        small = {
            name: WindowDataset(
                tokens=ds.tokens[:small_per_split],
                targets=ds.targets[:small_per_split],
                chroms=ds.chroms[:small_per_split],
                starts=ds.starts[:small_per_split],
                src_vocab=ds.src_vocab,
                tgt_vocab=ds.tgt_vocab,
            )
            for name, ds in splits.items()
        }
        artifact.save_dataset(os.path.join(out_dir, "dataset_small.npz"), small)
        verbose(f"wrote {os.path.join(out_dir, 'dataset_small.npz')}")
    return splits


def build_hic_graphs(
    splits: Dict[str, WindowDataset],
    hic_dir: str,
    out_dir: str,
    hicsize: int = 500_000,
    hicnorm: str = "SQRTVC",
    resolution_bp: int = 1000,
    upsample_5kb: bool = False,
    min_dist_bp: int = 0,
    max_dist_bp=None,
    verbose=print,
) -> None:
    """Build per-split Hi-C graph artifacts from RAWobserved dumps.

    Expects ``{hic_dir}/{chrom}.RAWobserved`` and (if hicnorm nonempty)
    ``{hic_dir}/{chrom}.{hicnorm}norm`` — the Juicer dump layout the
    reference consumes (reference: data/7create_graph_new.py:138-145).
    """
    graph_root = os.path.join(out_dir, "hic")
    os.makedirs(graph_root, exist_ok=True)
    n_pairs = hicsize // 2  # reference halves hicsize (7create_graph_new.py:168)
    for split, ds in splits.items():
        per_chrom = {}
        for chrom in ds.chrom_order():
            starts = ds.starts[ds.chroms == chrom]
            raw = os.path.join(hic_dir, f"{chrom}.RAWobserved")
            if not os.path.exists(raw):
                verbose(f"{chrom}: no Hi-C file, skipping")
                continue
            norm_path = None
            if hicnorm:
                norm_path = os.path.join(hic_dir, f"{chrom}.{hicnorm}norm")
                if not os.path.exists(norm_path):
                    norm_path = None
            # K562 flow: 5kb contacts replicate onto the 1kb grid IN the
            # stream (native reader upsample_grid=5 — reference writes a
            # 25x intermediate dump instead, data/extras/upsample_hic.py)
            s, r, v = hic.chrom_topk_edges(
                raw, starts, n_pairs, norm_path=norm_path,
                resolution_bp=resolution_bp, min_dist_bp=min_dist_bp,
                max_dist_bp=max_dist_bp,
                upsample_grid=5 if upsample_5kb else 1,
            )
            per_chrom[chrom] = (s, r, v)
            verbose(f"{split}/{chrom}: {len(s)} directed contact edges")
        path = hic.split_graph_paths(graph_root, split, str(hicsize), hicnorm)
        artifact.save_graph_edges(path, per_chrom)
        verbose(f"wrote {path}")
