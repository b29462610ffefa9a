"""The CNN->GCN per-chromosome feature contract (port of
chromegcn_tpu/data/loader.py:ChromFeatures)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ChromFeatures:
    """Per-chromosome saved CNN features (reference: utils/util_methods.py:
    183-199 writes {chrom: {forward, backward, target}})."""

    forward: np.ndarray    # (N, d) float32
    backward: np.ndarray   # (N, d) float32
    target: np.ndarray     # (N, n_targets) float32
    starts: Optional[np.ndarray] = None  # (N,) int64 — window starts (graph alignment)
