"""Variant-effect scoring: SNP-centred windows and ref/alt effect scores
(port of chromegcn_tpu/pipeline/variants.py).

GRASP eQTL SNPs -> centred windows -> ref/alt sequences -> per-label
prediction deltas of the trained window model, strand-averaged (the
reference's data/snp_data/10-12 scripts). The model runs on the device its
state lives on.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from chromegcn_tpu_torch.data.constants import EXTENDED_WINDOW_SIZE, SRC_VOCAB
from chromegcn_tpu_torch.ops.seq import encode_sequence
from chromegcn_tpu_torch.pipeline.genome import Fasta


def snp_window(pos: int, extended: int = EXTENDED_WINDOW_SIZE) -> Tuple[int, int]:
    """The extended window centred on a SNP (reference: 10_create_snp_bed.py)."""
    half = extended // 2
    start = max(0, pos - half)
    return start, start + extended


def variant_sequences(
    fasta: Fasta,
    chrom: str,
    pos: int,
    ref: str,
    alt: str,
    extended: int = EXTENDED_WINDOW_SIZE,
    src_vocab: Dict[str, int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenized (ref_seq, alt_seq) of a SNP's centred window. Raises if the
    genome does not hold the claimed ref allele at the SNP."""
    src_vocab = src_vocab or SRC_VOCAB
    start, end = snp_window(pos, extended)
    seq = fasta.fetch(chrom, start, end)
    offset = pos - start
    if seq[offset].lower() != ref.lower():
        raise ValueError(
            f"reference mismatch at {chrom}:{pos}: genome has "
            f"{seq[offset]!r}, expected {ref!r}"
        )
    alt_seq = seq[:offset] + alt.lower() + seq[offset + 1:]
    return encode_sequence(seq, src_vocab), encode_sequence(alt_seq, src_vocab)


@torch.no_grad()
def variant_effect_scores(
    window_state, comp_map: torch.Tensor, ref_tokens: np.ndarray, alt_tokens: np.ndarray
) -> np.ndarray:
    """Per-label effect sigmoid(alt) - sigmoid(ref), strand-averaged.

    ``window_state``: a WindowTrainState (its model the NonStrandSpecific
    wrapper), run in eval mode; ``ref_tokens``/``alt_tokens``: (L,) or
    (B, L)."""
    if ref_tokens.ndim == 1:
        ref_tokens, alt_tokens = ref_tokens[None], alt_tokens[None]
    model = window_state.model
    device = next(model.parameters()).device
    both = torch.as_tensor(np.concatenate([ref_tokens, alt_tokens], axis=0), device=device)
    was_training = model.training
    model.eval()
    try:
        _, _, logits = model(both, comp_map.to(device))
    finally:
        model.train(was_training)
    probs = torch.sigmoid(logits)
    b = ref_tokens.shape[0]
    return (probs[b:] - probs[:b]).cpu().numpy()


def score_snp_table(
    window_state,
    comp_map: torch.Tensor,
    fasta: Fasta,
    snps: Sequence[Tuple[str, int, str, str]],
    batch_size: int = 64,
    extended: int = EXTENDED_WINDOW_SIZE,
) -> np.ndarray:
    """Variant effect scores for a table of (chrom, pos, ref, alt) SNPs."""
    refs, alts = [], []
    for chrom, pos, ref, alt in snps:
        r, a = variant_sequences(fasta, chrom, pos, ref, alt, extended)
        refs.append(r)
        alts.append(a)
    refs, alts = np.stack(refs), np.stack(alts)
    return np.concatenate([
        variant_effect_scores(window_state, comp_map, refs[i:i + batch_size],
                              alts[i:i + batch_size])
        for i in range(0, len(refs), batch_size)], axis=0)
