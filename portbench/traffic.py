"""The one generator every traffic mix goes through: what a cell's
``traffic/<name>.json`` describes, drawn from ``--seed``.

Everything here is the benchmark's own, so a later change to the program
cannot move the yardstick. ``make_hic_edges`` is a copy of
``chromegcn_tpu_torch/data/synthetic.py:make_hic_edges`` (the numpy code as
it stands, so a seed gives the same contacts).

Dense inputs (features, targets, sequences, weights) are drawn on the
device with a ``torch.Generator`` there, in a few large calls.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


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


def graph_edges(params: dict, seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A traffic file's ``graph`` entry as a contact list."""
    return make_hic_edges(params["n_valid"], params["n_pairs"], seed=seed,
                          power=params["power"], hubness=params["hubness"],
                          compartment_frac=params["compartment_frac"])


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed of its own for each use of ``seed`` (any non-negative
    whole number)."""
    hi, lo = np.random.SeedSequence([seed, *keys]).generate_state(2, np.uint32).tolist()
    return (hi << 31) ^ lo


def device_generator(seed: int, device, *keys: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *keys))


def node_inputs(n_valid: int, n_pad: int, d: int, n_labels: int, rate: float,
                n_sets: int, gen: torch.Generator, device) -> List[Dict[str, torch.Tensor]]:
    """``n_sets`` sets of one chromosome's strand features (N(0, 1)) and
    Bernoulli(``rate``) targets, padded to ``n_pad`` rows with zeros as the
    runner pads them."""
    sets = []
    for _ in range(n_sets):
        x = torch.zeros(2, n_pad, d, device=device)
        x[:, :n_valid].normal_(generator=gen)
        t = torch.zeros(n_pad, n_labels, device=device)
        t[:n_valid].bernoulli_(rate, generator=gen)
        sets.append({"x_f": x[0], "x_r": x[1], "targets": t})
    return sets


def rule_offset(rate: float, scale: float) -> float:
    """The offset b with E[sigmoid(scale z + b)] = ``rate`` for z ~ N(0, 1),
    by Newton's method on Gauss-Hermite quadrature: the same for every
    seed."""
    z, w = np.polynomial.hermite_e.hermegauss(200)
    w = w / w.sum()
    b = float(np.log(rate / (1.0 - rate)))
    for _ in range(100):
        p = 1.0 / (1.0 + np.exp(-(scale * z + b)))
        b -= float((w * p).sum() - rate) / max(float((w * p * (1.0 - p)).sum()), 1e-12)
    return b


class LabelRule:
    """Targets that follow the features: label j of a window is
    Bernoulli(sigmoid(scale z_j + b)), z_j = (x_f + x_r) u_j / sqrt(2 d) with
    u ~ N(0, 1) drawn once for every split, so that z_j ~ N(0, 1) and each
    label is positive at ``rate``. A model trained on one split learns what
    holds on the others."""

    def __init__(self, d: int, n_labels: int, rate: float, scale: float,
                 gen: torch.Generator, device):
        self.u = torch.randn(d, n_labels, generator=gen, device=device) / (2 * d) ** 0.5
        self.scale, self.offset = scale, rule_offset(rate, scale)

    def targets(self, x_f: torch.Tensor, x_r: torch.Tensor,
                gen: torch.Generator) -> torch.Tensor:
        z = (x_f + x_r) @ self.u
        return torch.bernoulli(torch.sigmoid(self.scale * z + self.offset), generator=gen)


def window_batches(n_batches: int, batch: int, seq_length: int, n_labels: int, rate: float,
                   bases: List[int], gen: torch.Generator, device) -> List[Dict[str, torch.Tensor]]:
    """``n_batches`` batches of uniform random sequences over the token ids
    ``bases`` and their Bernoulli(``rate``) targets, every row in the loss."""
    table = torch.tensor(bases, dtype=torch.int32, device=device)
    idx = torch.randint(0, len(bases), (n_batches, batch, seq_length), generator=gen,
                        device=device)
    tokens = table[idx]
    targets = torch.empty(n_batches, batch, n_labels, device=device).bernoulli_(rate, generator=gen)
    mask = torch.ones(batch, dtype=torch.bool, device=device)
    return [{"tokens": tokens[b], "targets": targets[b], "row_mask": mask}
            for b in range(n_batches)]
