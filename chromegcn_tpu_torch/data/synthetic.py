"""Synthetic window datasets and Hi-C contact lists (port of
chromegcn_tpu/data/synthetic.py: ``make_window_dataset``,
``encode_style_label_names``, ``make_hic_edges``, ``graph_coupled_motifs``
and ``make_graph_coupled_dataset``; the numpy code is kept as is, so a seed
gives the reference's arrays)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from chromegcn_tpu_torch.data.constants import EXTENDED_WINDOW_SIZE, SRC_VOCAB
from chromegcn_tpu_torch.data.loader import WindowDataset


def encode_style_label_names(n_targets: int, cell_type: str = "GM12878") -> List[str]:
    """ENCODE-convention assay names in DeepSEA-like proportions (~125 DNase
    / 690 TFBS / 104 histone per 919 targets), so the per-label-type metric
    splits come out non-empty; the histone key is 'e116-h' for GM12878,
    'e123-h' otherwise."""
    eid = "e116" if cell_type == "GM12878" else "e123"
    n_dnase = max(1, round(n_targets * 125 / 919)) if n_targets >= 3 else 1
    n_hm = max(1, round(n_targets * 104 / 919)) if n_targets >= 3 else 1
    n_tf = max(0, n_targets - n_dnase - n_hm)
    names = [f"wgencodeawgdnasegm12878site{i}unipk" for i in range(n_dnase)]
    names += [f"wgencodeawgtfbsgm12878tf{i}unipk" for i in range(n_tf)]
    names += [f"{eid}-h3k{i}me" for i in range(n_hm)]
    return names[:n_targets]


def make_window_dataset(
    n_per_chrom: Dict[str, int],
    n_targets: int = 8,
    seq_length: int = EXTENDED_WINDOW_SIZE,
    seed: int = 0,
    cell_type: str = "GM12878",
) -> WindowDataset:
    """Windows with learnable structure: each label fires (in ~30% of the
    windows) on the presence of its own planted 6-mer motif."""
    rng = np.random.default_rng(seed)
    total = sum(n_per_chrom.values())
    tokens = rng.integers(0, 4, size=(total, seq_length)).astype(np.int32)
    motifs = rng.integers(0, 4, size=(n_targets, 6)).astype(np.int32)
    targets = np.zeros((total, n_targets), dtype=np.uint8)

    for t in range(n_targets):
        has = rng.random(total) < 0.3
        pos = rng.integers(0, seq_length - 6, size=total)
        for i in np.nonzero(has)[0]:
            tokens[i, pos[i] : pos[i] + 6] = motifs[t]
        targets[has, t] = 1

    chroms: List[str] = []
    starts: List[int] = []
    for chrom, n in n_per_chrom.items():
        chroms.extend([chrom] * n)
        starts.extend(range(0, n * 1000, 1000))

    tgt_vocab = {
        n: i for i, n in enumerate(encode_style_label_names(n_targets, cell_type))
    }
    return WindowDataset(
        tokens=tokens,
        targets=targets,
        chroms=np.asarray(chroms, dtype=object),
        starts=np.asarray(starts, dtype=np.int64),
        src_vocab=dict(SRC_VOCAB),
        tgt_vocab=tgt_vocab,
    )


def make_hic_edges(
    n_nodes: int,
    n_pairs: int,
    seed: int = 0,
    power: float = 1.5,
    hubness: float = 0.0,
    compartment_frac: float = 0.0,
    n_compartment_blocks: int = 32,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetric binary contact pairs with a power-law-ish distance profile
    (short-range contacts dominate, like real Hi-C).

    ``hubness`` in [0, 1] draws endpoints with probability proportional to
    ``(1-hubness) + hubness * w_i`` (``w_i`` Pareto(1.2) per-node
    propensity); ``compartment_frac`` in [0, 1) turns that fraction of pairs
    into long-range same-compartment contacts over ``n_compartment_blocks``
    alternating A/B blocks.
    """
    rng = np.random.default_rng(seed)
    n_draw = n_pairs * 2
    if hubness > 0.0:
        w = (1.0 - hubness) + hubness * (1.0 + rng.pareto(1.2, size=n_nodes))
        p = w / w.sum()
        i = rng.choice(n_nodes, size=n_draw, p=p)
    else:
        i = rng.integers(0, n_nodes, size=n_draw)
    # distance drawn heavy-tailed, sign random
    dist = np.maximum(1, (rng.pareto(power, size=n_draw) * 3).astype(np.int64))
    j = i + np.where(rng.random(n_draw) < 0.5, dist, -dist)
    if compartment_frac > 0.0:
        block = max(1, n_nodes // n_compartment_blocks)
        comp = (np.arange(n_nodes) // block) % 2
        lr = rng.random(n_draw) < compartment_frac
        for c in (0, 1):
            members = np.nonzero(comp == c)[0]
            sel = lr & (comp[np.clip(i, 0, n_nodes - 1)] == c)
            if sel.any() and len(members):
                if hubness > 0.0:
                    pm = p[members] / p[members].sum()
                    j[sel] = rng.choice(members, size=int(sel.sum()), p=pm)
                else:
                    j[sel] = rng.choice(members, size=int(sel.sum()))
    ok = (j >= 0) & (j < n_nodes) & (j != i)
    i, j = i[ok][:n_pairs], j[ok][:n_pairs]
    dense_keys = set()
    si, sj = [], []
    for a, b in zip(i.tolist(), j.tolist()):
        key = (a, b) if a < b else (b, a)
        if key not in dense_keys:
            dense_keys.add(key)
            si.append(key[0])
            sj.append(key[1])
    si = np.asarray(si, np.int32)
    sj = np.asarray(sj, np.int32)
    senders = np.concatenate([si, sj])
    receivers = np.concatenate([sj, si])
    vals = np.ones(senders.shape[0], np.float32)
    return senders, receivers, vals


def graph_coupled_motifs(
    rng: np.random.Generator, n_motifs: int, motif_len: int, n_targets: int
) -> Tuple[np.ndarray, np.ndarray]:
    """The (motifs, target->motif) tables of make_graph_coupled_dataset,
    drawn FIRST from its rng so external consumers (run_variants.py's
    planted-effect probe) can reconstruct exactly the tables a trained
    model saw by passing ``default_rng(same_seed)``. Motif m is planted at
    the deterministic in-window offset ``(m * motif_len) %
    (seq_length - motif_len)``."""
    motifs = rng.integers(0, 4, size=(n_motifs, motif_len)).astype(np.int32)
    mu = rng.integers(0, n_motifs, size=n_targets)  # target -> motif
    return motifs, mu


def make_graph_coupled_dataset(
    split_chroms: Dict[str, Dict[str, int]],
    n_targets: int = 919,
    seq_length: int = EXTENDED_WINDOW_SIZE,
    n_motifs: int = 64,
    motif_len: int = 8,
    motif_p: float = 0.2,
    neighbor_thresh: float = 0.3,
    pairs_per_node: float = 5.0,
    neighbor_only_frac: float = 0.0,
    hubness: float = 0.0,
    compartment_frac: float = 0.0,
    degree_coupled_frac: float = 0.0,
    cell_type: str = "GM12878",
    seed: int = 0,
):
    """Windows whose labels genuinely depend on Hi-C NEIGHBORS — the
    strongest data-free proxy for the paper's central claim (GCN beats
    CNN; reference scripts/analyze_results.py exists to measure exactly
    this comparison).

    Each window carries a latent motif-presence vector (motifs are planted
    8-mers the CNN can detect). Target t fires on window i iff window i
    carries motif mu(t) AND at least ``neighbor_thresh`` of i's Hi-C graph
    neighbors carry it too. A sequence-only model can recover the "own
    motif" factor but the neighbor factor is invisible to it — its
    precision is capped by P(neighbors qualify | own motif present) —
    while the graph stage sees the neighbors' features and can close the
    gap. Returns (splits, graphs): WindowDatasets per split plus
    per-chromosome COO contact edges in the artifact format
    (data/artifact.save_graph_edges).

    ``neighbor_only_frac`` > 0 makes the FIRST ``frac * n_targets``
    targets fire on the neighbor condition ALONE (own presence ignored) —
    an "enhancer-hijack"-style label carrying ZERO in-window sequence
    evidence. A sequence-only model's ceiling on these is the weak
    autocorrelation between a window's own motif and its neighbors'; the
    graph stage reads the neighbors directly. Round-4 addition for the
    focused CNN-vs-GCN separation experiment (run_nbrwin.py).
    """
    rng = np.random.default_rng(seed)
    motifs, mu = graph_coupled_motifs(rng, n_motifs, motif_len, n_targets)
    n_nbr_only = int(round(neighbor_only_frac * n_targets))

    splits: Dict[str, WindowDataset] = {}
    graphs: Dict[str, Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]] = {}
    for split, per_chrom in split_chroms.items():
        tok_parts, tgt_parts, chrom_col, start_col = [], [], [], []
        graphs[split] = {}
        for chrom, n in per_chrom.items():
            tokens = rng.integers(0, 4, size=(n, seq_length)).astype(np.int32)
            if degree_coupled_frac > 0:
                # degree-coupled labels need the graph FIRST: the last
                # `frac * n_motifs` motifs' presence probability scales
                # with the node's degree percentile (TF-at-enhancer-hub
                # style), which is what gives the reference's label-degree
                # mechanism axis (scripts/analyze_results.py) a real
                # spread — per-label MEAN degree otherwise concentrates
                # by CLT no matter how heavy the node-degree tail is
                # (DEGREE_r05). Branching (not reordering) keeps the rng
                # stream of the frac=0 path identical to prior rounds.
                s, r, v = make_hic_edges(
                    n, int(n * pairs_per_node), seed=rng.integers(1 << 30),
                    hubness=hubness, compartment_frac=compartment_frac,
                )
                deg = np.bincount(r, minlength=n).astype(np.float64)
                pct = deg.argsort().argsort() / max(n - 1, 1)
                present = rng.random((n, n_motifs)) < motif_p
                k = int(round(degree_coupled_frac * n_motifs))
                if k:
                    p_cpl = motif_p * (0.25 + 1.5 * pct)[:, None]
                    present[:, n_motifs - k:] = rng.random((n, k)) < p_cpl
            else:
                present = rng.random((n, n_motifs)) < motif_p
            for i in range(n):
                for m in np.nonzero(present[i])[0]:
                    # deterministic per-motif slot so motifs don't overwrite
                    # each other: motif m sits at offset m * motif_len
                    off = (m * motif_len) % (seq_length - motif_len)
                    tokens[i, off : off + motif_len] = motifs[m]
            if degree_coupled_frac == 0:
                s, r, v = make_hic_edges(
                    n, int(n * pairs_per_node), seed=rng.integers(1 << 30),
                    hubness=hubness, compartment_frac=compartment_frac,
                )
            graphs[split][chrom] = (s, r, v)
            # neighbor motif fraction over the directed edge list
            deg = np.maximum(np.bincount(r, minlength=n), 1)
            nbr = np.zeros((n, n_motifs), np.float32)
            np.add.at(nbr, r, present[s].astype(np.float32))
            nbr /= deg[:, None]
            nbr_ok = nbr[:, mu] >= neighbor_thresh
            own = present[:, mu].copy()
            if n_nbr_only:
                own[:, :n_nbr_only] = True  # neighbor condition alone
            targets = (own & nbr_ok).astype(np.uint8)
            tok_parts.append(tokens)
            tgt_parts.append(targets)
            chrom_col.extend([chrom] * n)
            start_col.extend(range(0, n * 1000, 1000))
        tgt_vocab = {
            n: i
            for i, n in enumerate(encode_style_label_names(n_targets, cell_type))
        }
        splits[split] = WindowDataset(
            tokens=np.concatenate(tok_parts),
            targets=np.concatenate(tgt_parts),
            chroms=np.asarray(chrom_col, dtype=object),
            starts=np.asarray(start_col, dtype=np.int64),
            src_vocab=dict(SRC_VOCAB),
            tgt_vocab=tgt_vocab,
        )
    return splits, graphs
