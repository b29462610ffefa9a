"""DNA sequence ops: reverse complement and vocab-derived permutations
(port of chromegcn_tpu/ops/seq.py).

The reverse complement is one gather, ``comp_map[tokens.flip(-1)]``: the
flip and the table lookup of the reference's Selene wrapper (reference:
models/NonStrandSpecific.py:13-44) in one indexing op.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from chromegcn_tpu_torch.data.constants import COMPLEMENT


def complement_permutation(src_vocab: Mapping[str, int]) -> np.ndarray:
    """Token-id permutation implementing the Watson-Crick complement, derived
    from the dataset's vocabulary; symbols without a complement entry map to
    themselves (reference: models/NonStrandSpecific.py:28-44 swaps only a/t
    and c/g)."""
    size = max(src_vocab.values()) + 1
    perm = np.arange(size, dtype=np.int32)
    for sym, idx in src_vocab.items():
        comp_sym = COMPLEMENT.get(sym.lower())
        if comp_sym is not None and comp_sym in src_vocab:
            perm[idx] = src_vocab[comp_sym]
    return perm


def reverse_complement(tokens: torch.Tensor, comp_map: torch.Tensor) -> torch.Tensor:
    """Reverse-complement (..., L) token ids along the last axis, with
    ``comp_map`` the (V,) permutation of ``complement_permutation`` on the
    tokens' device."""
    return comp_map[tokens.flip(-1).long()]


def encode_sequence(seq: str, src_vocab: Dict[str, int], unk: str = "n") -> np.ndarray:
    """Encode an ASCII DNA string into token ids (host-side, ingest path)."""
    unk_id = src_vocab[unk]
    lut = np.full(256, unk_id, dtype=np.int32)
    for sym, idx in src_vocab.items():
        lut[ord(sym)] = idx
        lut[ord(sym.upper())] = idx
    return lut[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]
