"""The CNN->GCN per-chromosome feature contract (port of
chromegcn_tpu/data/loader.py: ChromFeatures and its npz files)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


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
