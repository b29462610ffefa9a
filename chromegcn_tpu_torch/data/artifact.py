"""Hi-C graph artifacts (port of chromegcn_tpu/data/artifact.py:56-74).

Each split's file stores every chromosome's COO contact pairs as
``<chrom>/senders``, ``<chrom>/receivers`` and ``<chrom>/vals`` in one
compressed npz, mirroring the reference's pickled
``{split}_graphs_{size}_{norm}norm.pkl`` dict of CSR matrices (reference:
data/7create_graph_new.py:147-202). The window dataset artifact is not
ported yet (ROADMAP A10).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def save_graph_edges(
    path: str, per_chrom: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]
) -> None:
    """Save per-chromosome COO contact edges (senders, receivers, vals)."""
    arrays = {}
    for chrom, (s, r, v) in per_chrom.items():
        arrays[f"{chrom}/senders"] = np.asarray(s, np.int32)
        arrays[f"{chrom}/receivers"] = np.asarray(r, np.int32)
        arrays[f"{chrom}/vals"] = np.asarray(v, np.float32)
    np.savez_compressed(path, **arrays)


def load_graph_edges(path: str) -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    data = np.load(path, allow_pickle=False)
    chroms = {k.split("/")[0] for k in data.files}
    return {
        c: (data[f"{c}/senders"], data[f"{c}/receivers"], data[f"{c}/vals"])
        for c in chroms
    }
