"""Window datasets, their fixed-shape batches, and the CNN->GCN
per-chromosome feature contract (port of chromegcn_tpu/data/loader.py; the
numpy code is copied, so batches and files come out equal).

Every window is exactly ``seq_length`` tokens, so batching is reshaping; the
tail batch is padded with copies of dataset row 0 and carries a row mask
instead of being resized (reference: data/loader.py:54-83).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np


@dataclasses.dataclass
class WindowDataset:
    """One split's windows: tokens, multi-hot labels, and genomic locations."""

    tokens: np.ndarray        # (N, L) int32
    targets: np.ndarray       # (N, n_targets) uint8/float32
    chroms: np.ndarray        # (N,) object/str chrom names
    starts: np.ndarray        # (N,) int64 window start positions
    src_vocab: Dict[str, int]
    tgt_vocab: Dict[str, int]

    def __len__(self) -> int:
        return self.tokens.shape[0]

    @property
    def n_targets(self) -> int:
        return self.targets.shape[1]

    def chrom_order(self) -> List[str]:
        """Chromosomes in first-appearance order (the feature dump groups by
        appearance — reference: utils/util_methods.py:183-199)."""
        seen: List[str] = []
        for c in self.chroms:
            if c not in seen:
                seen.append(c)
        return seen


@dataclasses.dataclass
class Batch:
    tokens: np.ndarray     # (B, L) int32
    targets: np.ndarray    # (B, n_targets) float32
    row_mask: np.ndarray   # (B,) bool — False for padding rows
    indices: np.ndarray    # (B,) int64 — dataset row per batch row (0 for pads)


def iterate_batches(
    dataset: WindowDataset,
    batch_size: int,
    shuffle: bool = False,
    rng: Optional[np.random.Generator] = None,
    drop_last: bool = False,
) -> Iterator[Batch]:
    """Yield fixed-size batches; the tail batch is padded with copies of
    dataset row 0 and row_mask False on them. ``drop_last`` mirrors the
    reference's ``opt.drop_last`` (reference: data_loader.py:35-37)."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(order)
    n_batches = n // batch_size if drop_last else -(-n // batch_size)
    for b in range(n_batches):
        idx = order[b * batch_size : (b + 1) * batch_size]
        valid = idx.shape[0]
        if valid < batch_size:
            idx = np.concatenate([idx, np.zeros(batch_size - valid, np.int64)])
        mask = np.zeros(batch_size, bool)
        mask[:valid] = True
        yield Batch(
            tokens=dataset.tokens[idx].astype(np.int32),
            targets=dataset.targets[idx].astype(np.float32),
            row_mask=mask,
            indices=idx,
        )


@dataclasses.dataclass
class ChromFeatures:
    """Per-chromosome saved CNN features (reference: utils/util_methods.py:
    183-199 writes {chrom: {forward, backward, target}})."""

    forward: np.ndarray    # (N, d) float32
    backward: np.ndarray   # (N, d) float32
    target: np.ndarray     # (N, n_targets) float32
    starts: Optional[np.ndarray] = None  # (N,) int64 — window starts (graph alignment)


def save_chrom_features(path: str, features: Dict[str, ChromFeatures]) -> None:
    """Write the per-split feature dict as a compressed npz, one
    ``<chrom>/<field>`` array each (reference: data/loader.py:98-107)."""
    arrays = {}
    for chrom, cf in features.items():
        arrays[f"{chrom}/forward"] = cf.forward
        arrays[f"{chrom}/backward"] = cf.backward
        arrays[f"{chrom}/target"] = cf.target
        if cf.starts is not None:
            arrays[f"{chrom}/starts"] = cf.starts
    np.savez_compressed(path, **arrays)


def load_chrom_features(path: str) -> Dict[str, ChromFeatures]:
    """Read what ``save_chrom_features`` (or the JAX package's) wrote."""
    data = np.load(path, allow_pickle=False)
    chroms: Dict[str, Dict[str, np.ndarray]] = {}
    for key in data.files:
        chrom, field = key.rsplit("/", 1)
        chroms.setdefault(chrom, {})[field] = data[key]
    return {
        c: ChromFeatures(
            forward=v["forward"],
            backward=v["backward"],
            target=v["target"],
            starts=v.get("starts"),
        )
        for c, v in chroms.items()
    }
