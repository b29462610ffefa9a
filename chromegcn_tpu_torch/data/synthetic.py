"""Synthetic Hi-C contact lists at chromosome scale (port of
chromegcn_tpu/data/synthetic.py:make_hic_edges, numpy code kept as is so the
edge arrays come out equal)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
