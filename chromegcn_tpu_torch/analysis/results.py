"""Results analysis: compare runs, per-label metrics, CNN-vs-GCN deltas
(port of chromegcn_tpu/analysis/results.py).

Importable functions over the runs' prediction snapshots
(`<run_dir>/epochs/best_metrics.npz`), in place of the reference's
scripts/analyze_results.py. ``per_label_table`` computes its curves with the
port's numpy metrics (utils/metrics.py), where the JAX package calls
sklearn; they are the same curves.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from chromegcn_tpu_torch.utils import metrics
from chromegcn_tpu_torch.utils.evals import _label_type_indices


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def load_best_predictions(run_dir: str, which: str = "metrics") -> Dict[str, np.ndarray]:
    """Load the best-epoch prediction snapshot of a run
    (written by utils.evals.EpochLogger.maybe_snapshot)."""
    path = os.path.join(run_dir, "epochs", f"best_{which}.npz")
    data = np.load(path)
    return {k: data[k] for k in data.files}


def per_label_table(
    preds: np.ndarray,
    targets: np.ndarray,
    label_names: Sequence[str],
) -> Dict[str, np.ndarray]:
    """Per-label AUROC/AUPR/recall@50%FDR arrays (aligned to label_names).

    Labels where a metric is undefined get NaN (the aggregate functions skip
    them, reference semantics — utils/metrics.py:243-247).
    """
    n = targets.shape[1]
    out = {
        "auroc": np.full(n, np.nan),
        "aupr": np.full(n, np.nan),
        "fdr": np.full(n, np.nan),
    }
    for i in range(n):
        t, p = targets[:, i:i + 1], preds[:, i:i + 1]
        if not np.isfinite(p).all():
            continue  # sklearn raises on non-finite scores; the reference skips them
        auc = metrics.auroc(t, p)[3]
        if auc.size:
            out["auroc"][i] = auc[0]
        precision, recall = metrics._pr_curve_one(np.asarray(t[:, 0], np.float64), p[:, 0])
        out["aupr"][i] = -np.trapezoid(precision, recall)
        hit = np.nonzero(1 - precision <= 0.5)[0]
        if hit.size:
            out["fdr"][i] = recall[hit[0]]
    return out


def compare_runs(
    run_a: str,
    run_b: str,
    label_names: Sequence[str],
    cell_type: str = "GM12878",
) -> Dict[str, Dict[str, float]]:
    """Head-to-head comparison (e.g. CNN vs ChromeGCN) on test snapshots,
    overall and per label type (TFBS / HM / DNase)."""
    a = load_best_predictions(run_a)
    b = load_best_predictions(run_b)
    groups = _label_type_indices(label_names, cell_type)
    groups["all"] = list(range(len(label_names)))

    def summarize(preds, targets, idx):
        if not idx:
            return {}
        p, t = preds[:, idx], targets[:, idx]
        return {
            "meanAUC": metrics.auroc(t, p)[0],
            "meanAUPR": metrics.aupr(t, p)[0],
            "meanFDR": metrics.fdr(t, p)[0],
        }

    report = {}
    for gname, idx in groups.items():
        ra = summarize(a["test_preds"], a["test_targets"], idx)
        rb = summarize(b["test_preds"], b["test_targets"], idx)
        report[gname] = {
            **{f"a_{k}": v for k, v in ra.items()},
            **{f"b_{k}": v for k, v in rb.items()},
            **{
                f"delta_{k}": rb[k] - ra[k]
                for k in ra
                if k in rb and np.isfinite(ra[k]) and np.isfinite(rb[k])
            },
        }
    return report


def label_degree_weights(
    chrom_graphs: Sequence,
    chrom_targets: Sequence[np.ndarray],
) -> np.ndarray:
    """Per-label average node degree — the x-axis of the Δ-vs-degree plot.

    For each label ℓ: mean over all (chromosome, node) pairs carrying ℓ of
    that node's degree in its chromosome graph. Reproduces reference
    scripts/analyze_results.py:226-267 (get_label_weights), including its
    clamp semantics: adjacency entries above 1 are clamped to 1 but
    fractional entries contribute as-is (analyze_results.py:256-257
    ``chrom_adj_d[chrom_adj_d>1] = 1`` then row .sum()).

    Args:
      chrom_graphs: per-chromosome ops.sparse.SparseGraph (or any object
        with senders/receivers/vals/n_edges/n_nodes; tensors or arrays).
      chrom_targets: per-chromosome (n_i, n_labels) 0/1 arrays aligned to
        nodes 0..n_i-1 of the matching graph (n_i <= graph.n_nodes; the
        padded tail carries no targets).

    Returns: (n_labels,) float array; NaN for labels with no positive node
    (reference: 0/0 division).
    """
    if len(chrom_graphs) != len(chrom_targets):
        raise ValueError("need one target array per chromosome graph")
    n_labels = np.asarray(chrom_targets[0]).shape[1]
    neighbor_count = np.zeros(n_labels, np.float64)
    label_count = np.zeros(n_labels, np.float64)
    for graph, targets in zip(chrom_graphs, chrom_targets):
        targets = np.asarray(targets)
        n_edges = int(graph.n_edges)
        receivers = _numpy(graph.receivers)[:n_edges]
        vals = np.minimum(_numpy(graph.vals)[:n_edges], 1.0)
        deg = np.zeros(graph.n_nodes, np.float64)
        np.add.at(deg, receivers, vals)
        pos = targets > 0
        neighbor_count += pos.T @ deg[: targets.shape[0]]
        label_count += pos.sum(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        return (neighbor_count / label_count).astype(np.float32)


def write_per_label_csv(
    path: str,
    preds: np.ndarray,
    targets: np.ndarray,
    label_names: Sequence[str],
) -> None:
    table = per_label_table(preds, targets, label_names)
    with open(path, "w") as f:
        f.write("label,auroc,aupr,recall_at_50fdr\n")
        for i, name in enumerate(label_names):
            f.write(
                f"{name},{table['auroc'][i]:.6f},{table['aupr'][i]:.6f},{table['fdr'][i]:.6f}\n"
            )
