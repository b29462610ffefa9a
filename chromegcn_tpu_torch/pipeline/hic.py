"""Hi-C graph construction: normalized top-k contact selection per chromosome
(port of chromegcn_tpu/pipeline/hic.py).

Replaces reference pipeline step 7 (data/7create_graph_new.py):
- read the KR/VC/SQRTVC normalization vector (NaN/0 -> discard;
  reference: data/7create_graph_new.py:51-65)
- stream RAWobserved contacts, normalize val/(norm[b1/res]*norm[b2/res]),
  keep the top hic_edges/2 pairs among peak-window bins
  (reference: data/7create_graph_new.py:66-116,168)
- emit a symmetric binary COO adjacency over window indices
  (reference: data/7create_graph_new.py:108-120)

Also covers the 5kb->1kb upsampling used for K562
(reference: data/extras/upsample_hic.py:25-45).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import numpy as np

from chromegcn_tpu_torch import native_bridge


def read_norm_vector(path: str) -> np.ndarray:
    """Per-bin normalization values; NaN/0 become 0 ("discard"), matching
    the reference's inf mapping (val/inf == 0 never survives top-k)."""
    vals = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                v = float(line)
            except ValueError:
                v = float("nan")
            vals.append(0.0 if (math.isnan(v) or v == 0.0) else v)
    return np.asarray(vals, dtype=np.float64)


def chrom_topk_edges(
    raw_path: str,
    window_starts: np.ndarray,
    n_pairs: int,
    norm_path: Optional[str] = None,
    resolution_bp: int = 1000,
    min_dist_bp: int = 0,
    max_dist_bp: Optional[int] = None,
    upsample_grid: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Top-k contact pairs for one chromosome as window-index COO.

    Args:
      raw_path: RAWobserved contact list (bin1 \t bin2 \t count).
      window_starts: sorted genomic start positions of this chromosome's
        peak windows (the bin vocabulary).
      n_pairs: number of undirected pairs to keep (= hicsize / 2,
        reference: data/7create_graph_new.py:168).
      norm_path: optional normalization vector file.
      min_dist_bp: genomic-distance floor, applied while streaming (BEFORE
        top-k selection) — the old graph builder's min_distance_threshold
        (reference: data/7create_graph_old.py:166 ``abs(pos1-pos2) >=``;
        the "min1000" in its artifact names). 0 disables.
      max_dist_bp: optional distance ceiling, also pre-top-k. This is a
        framework extension (the reference has no max cutoff); a capped
        graph selects its k best among qualifying contacts.
      upsample_grid: > 1 expands each coarse contact onto the grid x grid
        fine-resolution offsets while streaming (K562 5kb -> 1kb flow,
        reference: data/extras/upsample_hic.py:25-45) — no intermediate
        25x dump is written.

    Returns (senders, receivers, vals): symmetric directed COO over window
    indices with binary values (reference: create_adj_mat sets 1 both ways,
    data/7create_graph_new.py:108-120).
    """
    window_starts = np.asarray(window_starts, dtype=np.int64)
    norm = read_norm_vector(norm_path) if norm_path else None
    b1, b2, _vals = native_bridge.hic_topk(
        raw_path, window_starts, n_pairs, norm=norm,
        resolution_bp=resolution_bp, min_dist_bp=min_dist_bp,
        max_dist_bp=max_dist_bp, upsample_grid=upsample_grid,
    )
    idx = {int(s): i for i, s in enumerate(window_starts)}
    i1 = np.asarray([idx[int(b)] for b in b1], dtype=np.int32)
    i2 = np.asarray([idx[int(b)] for b in b2], dtype=np.int32)
    # symmetric binary adjacency; duplicates collapse at graph build
    senders = np.concatenate([i1, i2])
    receivers = np.concatenate([i2, i1])
    vals = np.ones(senders.shape[0], dtype=np.float32)
    return senders, receivers, vals


def upsample_contacts_5kb_to_1kb(
    bin1: np.ndarray, bin2: np.ndarray, vals: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Replicate each 5kb contact over the 5x5 grid of 1kb offsets
    (reference: data/extras/upsample_hic.py:25-45, used for K562)."""
    offsets = np.arange(5, dtype=np.int64) * 1000
    o1, o2 = np.meshgrid(offsets, offsets, indexing="ij")
    o1, o2 = o1.ravel(), o2.ravel()
    b1 = (bin1[:, None] + o1[None, :]).ravel()
    b2 = (bin2[:, None] + o2[None, :]).ravel()
    v = np.repeat(np.asarray(vals, np.float64), 25)
    return b1, b2, v


def split_graph_paths(graph_root: str, split: str, hicsize: str, hicnorm: str) -> str:
    """Artifact path contract mirroring the reference's pickle names
    (reference: finetune.py:21)."""
    return os.path.join(graph_root, f"{split}_graphs_{hicsize}_{hicnorm}norm.npz")
