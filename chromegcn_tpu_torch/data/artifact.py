"""Dataset and Hi-C graph artifacts (port of chromegcn_tpu/data/artifact.py,
numpy code copied, so a file written by either package loads in the other).

The dataset file is one compressed npz: per split ``<split>/tokens`` (int8),
``<split>/targets`` (uint8), ``<split>/starts`` and ``<split>/chroms``, and
the json-encoded vocabularies in ``meta`` (the reference's
``train_valid_test.pt``, reference: data/create_torch_data.py:224-256).

Each split's graph file stores every chromosome's COO contact pairs as
``<chrom>/senders``, ``<chrom>/receivers`` and ``<chrom>/vals`` in one
compressed npz, mirroring the reference's pickled
``{split}_graphs_{size}_{norm}norm.pkl`` dict of CSR matrices (reference:
data/7create_graph_new.py:147-202).
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np

from chromegcn_tpu_torch.data.loader import WindowDataset


def save_dataset(path: str, splits: Dict[str, WindowDataset]) -> None:
    arrays = {}
    meta = {}
    for split, ds in splits.items():
        arrays[f"{split}/tokens"] = ds.tokens.astype(np.int8)
        arrays[f"{split}/targets"] = ds.targets.astype(np.uint8)
        arrays[f"{split}/starts"] = ds.starts.astype(np.int64)
        # numpy sizes the unicode dtype: a fixed width would cut long contig names
        arrays[f"{split}/chroms"] = np.asarray([str(c) for c in ds.chroms])
        meta["src_vocab"] = ds.src_vocab
        meta["tgt_vocab"] = ds.tgt_vocab
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_dataset(path: str) -> Dict[str, WindowDataset]:
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["meta"]).decode())
    splits: Dict[str, WindowDataset] = {}
    names = {k.split("/")[0] for k in data.files if "/" in k}
    for split in sorted(names):
        splits[split] = WindowDataset(
            tokens=data[f"{split}/tokens"].astype(np.int32),
            targets=data[f"{split}/targets"],
            chroms=data[f"{split}/chroms"].astype(object),
            starts=data[f"{split}/starts"],
            src_vocab=meta["src_vocab"],
            tgt_vocab=meta["tgt_vocab"],
        )
    return splits


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
