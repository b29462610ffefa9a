"""Plain numpy reference of the epoch's host metrics, the semantics of the
reference's sklearn-based ``utils/metrics.py`` and ``utils/evals.py``,
written label by label from the curves' definitions. It imports nothing of
the program.

- AUROC: the area under the ROC curve (trapezoids over distinct
  thresholds); labels with one class only are skipped.
- The precision-recall curve as sklearn's ``precision_recall_curve`` builds
  it (distinct thresholds, cut at the first full-recall point, the (1, 0)
  end appended); a label with no positive gets the curve ([0, 1], [1, 0]).
  AUPR is its trapezoid area, "FDR" the recall at its first point (from
  full recall) whose false-discovery rate is at most 0.5, and mAP the
  step-wise average precision, macro-averaged over every label.
- ACC, HA, ebF1, miF1 and maF1 of the predictions binarised at a
  threshold.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

COMPARED = ("mAP", "meanAUC", "medianAUC", "meanAUPR", "medianAUPR", "meanFDR",
            "medianFDR", "ACC", "HA", "ebF1", "miF1", "maF1")


def _curve_points(t: np.ndarray, p: np.ndarray, dtype):
    """(true positives, false positives) at each distinct threshold, from
    the highest down."""
    order = np.argsort(-p, kind="mergesort")
    ps, ts = p[order], t[order].astype(dtype)
    last = np.r_[np.nonzero(ps[1:] != ps[:-1])[0], len(ps) - 1]
    tps = np.cumsum(ts, dtype=dtype)[last]
    return tps, (last + 1).astype(dtype) - tps


def auroc(t, p, dtype=np.float64):
    positives = t.sum()
    if positives == 0 or positives == len(t):
        return None
    tps, fps = _curve_points(t, p, dtype)
    tpr = np.r_[0.0, tps / tps[-1]].astype(dtype)
    fpr = np.r_[0.0, fps / fps[-1]].astype(dtype)
    return float(np.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2, dtype=dtype))


def pr_curve(t, p, dtype=np.float64):
    """(precision, recall) from full recall down to the (1, 0) end."""
    tps, fps = _curve_points(t, p, dtype)
    if tps[-1] == 0:
        return np.array([0.0, 1.0]), np.array([1.0, 0.0])
    cut = int(np.searchsorted(tps, tps[-1])) + 1
    precision = (tps / (tps + fps))[:cut].astype(dtype)
    recall = (tps / tps[-1])[:cut].astype(dtype)
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0]


def metrics(preds: np.ndarray, targets: np.ndarray, threshold: float = 0.5,
            dtype=np.float64) -> Dict[str, float]:
    """The compared metrics of (rows, labels) predictions, computed in
    ``dtype``."""
    preds, targets = preds.astype(dtype), targets.astype(dtype)
    aucs, auprs, fdrs, aps = [], [], [], []
    for i in range(targets.shape[1]):
        t, p = targets[:, i], preds[:, i]
        auc = auroc(t, p, dtype)
        if auc is not None:
            aucs.append(auc)
        precision, recall = pr_curve(t, p, dtype)
        widths = recall[:-1] - recall[1:]
        auprs.append(float(np.sum(widths * (precision[:-1] + precision[1:]) / 2)))
        aps.append(float(np.sum(widths * precision[:-1])))
        hit = np.nonzero(precision >= 0.5)[0]
        if hit.size:
            fdrs.append(float(recall[hit[0]]))
    binary = (preds >= threshold).astype(dtype)
    tp = (targets * binary).sum(0)
    fp = ((1 - targets) * binary).sum(0)
    fn = (targets * (1 - binary)).sum(0)
    per_label = 2 * tp + fp + fn
    row_tp = (targets * binary).sum(1)
    row_size = targets.sum(1) + binary.sum(1)
    rows = row_size > 0
    return {
        "mAP": float(np.mean(aps)),
        "meanAUC": float(np.mean(aucs)), "medianAUC": float(np.median(aucs)),
        "meanAUPR": float(np.mean(auprs)), "medianAUPR": float(np.median(auprs)),
        "meanFDR": float(np.mean(fdrs)), "medianFDR": float(np.median(fdrs)),
        "ACC": float(np.mean(np.all(targets == binary, axis=1))),
        "HA": float(1.0 - np.mean(targets != binary)),
        "ebF1": float(np.mean(2 * row_tp[rows] / row_size[rows])) if rows.any() else 0.0,
        "miF1": float(2 * tp.sum() / per_label.sum()) if per_label.sum() > 0 else 0.0,
        "maF1": float(np.mean(2 * tp[per_label > 0] / per_label[per_label > 0]))
        if (per_label > 0).any() else 0.0,
    }


def gap(program: Dict[str, float], preds: np.ndarray, targets: np.ndarray,
        dtype=np.float64) -> float:
    """Largest absolute gap between the program's metrics and the
    reference's over the same predictions."""
    ref = metrics(preds, targets, dtype=dtype)
    return max(abs(float(program[k]) - ref[k]) for k in COMPARED)
