"""Publication plots over saved predictions.

Covers the reference's plotting surface:
- ROC / PR curve plots (reference: utils/metrics.py:255-302 plot_auroc /
  plot_aupr — micro-averaged curve over all labels)
- per-label metric scatter comparing two runs (reference:
  scripts/analyze_results.py:68-95 plot_comparison)
- per-label metric *difference* vs label degree-weight, marker-coded by
  label type (reference: scripts/analyze_results.py:97-177
  plot_label_difference)
- violin plot of per-label metric distributions across runs (reference:
  scripts/analyze_results.py:192-223 violin_plot)

All functions return the matplotlib Figure and optionally save it; they
take plain numpy arrays. Port of chromegcn_tpu/analysis/plots.py:
matplotlib is imported inside the functions, and the curves of
``plot_auroc``/``plot_aupr`` are the port's numpy ones (utils/metrics.py),
the same as sklearn's, which the JAX package calls.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from chromegcn_tpu_torch.utils import metrics
from chromegcn_tpu_torch.utils.evals import _label_type_indices

# marker per label type (reference scripts/analyze_results.py:138-145)
LABEL_TYPE_MARKERS = {"tfbs": "o", "hm": "^", "dnase": "x"}


def _fig():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_auroc(
    targets: np.ndarray,
    preds: np.ndarray,
    label: str = "",
    save_path: Optional[str] = None,
):
    """Micro-averaged ROC curve over all labels (reference
    utils/metrics.py:255-278)."""
    plt = _fig()
    fpr, tpr, _ = metrics.roc_curve(targets.ravel(), preds.ravel())
    fig, ax = plt.subplots()
    ax.plot(fpr, tpr, label=f"{label} (AUC={np.trapezoid(tpr, fpr):.4f})".strip())
    ax.plot([0, 1], [0, 1], "k--", lw=0.8)
    ax.set_xlabel("FPR", fontsize=15)
    ax.set_ylabel("TPR", fontsize=15)
    ax.legend(loc="lower right")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    return fig


def plot_aupr(
    targets: np.ndarray,
    preds: np.ndarray,
    label: str = "",
    save_path: Optional[str] = None,
):
    """Micro-averaged precision-recall curve (reference
    utils/metrics.py:280-302)."""
    plt = _fig()
    prec, rec = metrics._pr_curve_one(np.asarray(targets.ravel(), np.float64), preds.ravel())
    ap = -np.sum(np.diff(rec) * prec[:-1])
    fig, ax = plt.subplots()
    ax.plot(rec, prec, label=f"{label} (AP={ap:.4f})".strip())
    ax.set_xlabel("Recall", fontsize=15)
    ax.set_ylabel("Precision", fontsize=15)
    ax.legend(loc="upper right")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    return fig


def plot_comparison(
    x: np.ndarray,
    y: np.ndarray,
    metric: str = "AUC",
    names: Sequence[str] = ("window CNN", "ChromeGCN"),
    save_path: Optional[str] = None,
):
    """Per-label metric scatter of run y vs run x with the y=x diagonal
    (reference scripts/analyze_results.py:68-95)."""
    plt = _fig()
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    fig, ax = plt.subplots()
    lo = float(min(x.min(), y.min()))
    hi = float(max(x.max(), y.max()))
    pad = 0.02 * (hi - lo + 1e-12)
    ax.plot([lo - pad, hi + pad], [lo - pad, hi + pad], "k--", lw=0.8)
    ax.scatter(x, y, s=14)
    ax.set_xlabel(f"{names[0]} {metric}", fontsize=13)
    ax.set_ylabel(f"{names[1]} {metric}", fontsize=13)
    frac_better = float((y > x).mean())
    ax.set_title(f"{frac_better:.0%} of labels improved")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    return fig


def plot_label_difference(
    base: np.ndarray,
    refined: np.ndarray,
    label_names: Sequence[str],
    degree_weights: Optional[np.ndarray] = None,
    metric: str = "AUC",
    cell_type: str = "GM12878",
    save_path: Optional[str] = None,
):
    """Per-label (refined - base) metric difference vs each label's
    degree weight, marker-coded by label type (TF / HM / DNase) and
    color-coded by sign (reference scripts/analyze_results.py:97-177).

    ``degree_weights`` comes from analysis.results.label_degree_weights
    (reference get_label_weights, analyze_results.py:226-267)."""
    plt = _fig()
    base = np.asarray(base, float)
    refined = np.asarray(refined, float)
    diff = refined - base
    xs = (
        np.asarray(degree_weights, float)
        if degree_weights is not None
        else np.arange(len(diff), dtype=float)
    )
    type_idx = _label_type_indices(list(label_names), cell_type)
    claimed = set()
    for idx in type_idx.values():
        claimed.update(idx)
    other = [i for i in range(len(diff)) if i not in claimed]
    if other:
        type_idx = dict(type_idx, other=other)
        markers = dict(LABEL_TYPE_MARKERS, other="s")
    else:
        markers = LABEL_TYPE_MARKERS
    fig, ax = plt.subplots()
    for type_name, marker in markers.items():
        idx = np.asarray(type_idx.get(type_name, []), int)
        if idx.size == 0:
            continue
        pos = idx[diff[idx] >= 0]
        neg = idx[diff[idx] < 0]
        ax.scatter(xs[pos], diff[pos], color="#00c26e", marker=marker, s=20,
                   label=type_name)
        ax.scatter(xs[neg], diff[neg], color="#ff0055", marker=marker, s=20)
    ax.axhline(0.0, color="k", lw=0.8)
    ax.set_xlabel("label degree weight" if degree_weights is not None else "label",
                  fontsize=13)
    ax.set_ylabel(f"Δ{metric} (refined − base)", fontsize=13)
    ax.legend()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    return fig


def violin_plot(
    per_label_metrics: Dict[str, np.ndarray],
    metric: str = "AUC",
    save_path: Optional[str] = None,
):
    """Violin plot of per-label metric distributions, one violin per run
    (reference scripts/analyze_results.py:192-223); medians and means
    overlaid as white squares/circles."""
    plt = _fig()
    names = list(per_label_metrics)
    data = [np.asarray(per_label_metrics[n], float) for n in names]
    fig, ax = plt.subplots()
    parts = ax.violinplot(data, showmeans=False, showmedians=False,
                          showextrema=False)
    for pc in parts["bodies"]:
        pc.set_alpha(0.7)
    inds = np.arange(1, len(data) + 1)
    ax.scatter(inds, [np.median(d) for d in data], marker="s", color="white",
               s=8, zorder=3)
    ax.scatter(inds, [np.mean(d) for d in data], marker="o", color="white",
               s=8, zorder=3)
    ax.set_xticks(inds)
    ax.set_xticklabels(names)
    ax.set_ylabel(metric, fontsize=13)
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    return fig
