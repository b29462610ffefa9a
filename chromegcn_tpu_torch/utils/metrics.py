"""Evaluation metrics: per-label AUROC / AUPR / recall-at-50%-FDR, mAP, F1s
(port of chromegcn_tpu/utils/metrics.py, numpy only).

Vectorized numpy implementations of the reference's sklearn semantics
(reference: utils/metrics.py:25-303; the JAX package pins them to 1e-12
against sklearn in tests/test_metrics.py, and tests/test_torch_cli.py pins
this copy to the JAX package's), including:
- skipping labels where AUROC is undefined (single-class columns raise
  in sklearn and the reference swallows them — utils/metrics.py:243-247),
- "FDR" = recall at the first threshold where FDR (=1-precision) <= 0.5
  (reference: utils/metrics.py:148-165),
- AUPR via the (recall, precision) trapezoid, not average_precision
  (reference: utils/metrics.py:172-173),
- sklearn's degenerate all-negative PR curve (an AUPR of 0.5, a FDR-recall
  of 0).

- ``roc_curve``: sklearn's ``roc_curve`` (drop_intermediate=True, a first
  threshold of +inf), which ``find_optimal_cutoff`` (Youden's J per label)
  and ``analysis/plots.py`` read.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def _summary(out) -> Tuple[float, float, float, np.ndarray]:
    arr = np.asarray(out)
    if arr.size == 0:
        return float("nan"), float("nan"), float("nan"), arr
    return float(arr.mean()), float(np.median(arr)), float(arr.var()), arr


def _pr_curve_one(t: np.ndarray, p: np.ndarray):
    """(precision, recall) exactly as sklearn.precision_recall_curve
    (pos_label=1) returns them: recall decreasing from full recall down to
    the highest threshold, with the (1, 0) endpoint appended and the curve
    cut at the first full-recall point. All-negative labels reproduce
    sklearn's degenerate ([0, 1], [1, 0]) curve — the sklearn-based
    implementation this replaces recorded an AUPR of 0.5 and a FDR-recall
    of 0 for them (not a skip), and exactness against it is pinned in
    tests."""
    order = np.argsort(p, kind="stable")[::-1]
    ts = t[order]
    ps = p[order]
    distinct = np.nonzero(np.r_[ps[1:] != ps[:-1], True])[0]
    tps = np.cumsum(ts)[distinct]
    if tps[-1] == 0:
        return np.asarray([0.0, 1.0]), np.asarray([1.0, 0.0])
    fps = distinct + 1 - tps
    last = int(np.searchsorted(tps, tps[-1]))
    precision = tps[: last + 1] / (tps[: last + 1] + fps[: last + 1])
    recall = tps[: last + 1] / tps[-1]
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    return precision, recall


def auroc(targets: np.ndarray, preds: np.ndarray) -> Tuple[float, float, float, np.ndarray]:
    """Per-label ROC AUC; returns (mean, median, var, all).

    Computed as the tie-corrected Mann-Whitney U statistic (midranks),
    identical to sklearn's trapezoidal roc_auc_score — pinned exact
    against sklearn incl. heavy ties in tests/test_metrics.py.
    Single-class labels are skipped (sklearn raises there; the reference
    swallows it)."""
    out = []
    t64 = np.asarray(targets, np.float64)
    for i in range(targets.shape[1]):
        t = t64[:, i]
        npos = t.sum()
        n = t.shape[0]
        nneg = n - npos
        if npos == 0 or nneg == 0:
            continue
        p = preds[:, i]
        order = np.argsort(p, kind="stable")
        sp = p[order]
        starts = np.nonzero(np.r_[True, sp[1:] != sp[:-1]])[0]
        ends = np.r_[starts[1:], n]
        mid = (starts + ends - 1) / 2.0 + 1.0  # average 1-based rank
        ranks = np.empty(n)
        ranks[order] = np.repeat(mid, ends - starts)
        u = ranks[t > 0].sum() - npos * (npos + 1) / 2.0
        v = u / (npos * nneg)
        if not math.isnan(v):
            out.append(v)
    return _summary(out)


def _aupr_fdr(targets, preds, fdr_cutoff: float = 0.5):
    """Both PR-derived metric vectors from ONE curve pass per label (the
    previous sklearn implementation built the identical curve twice)."""
    auprs, fdrs = [], []
    t64 = np.asarray(targets, np.float64)
    for i in range(targets.shape[1]):
        precision, recall = _pr_curve_one(t64[:, i], preds[:, i])
        # sklearn.auc(recall, precision): trapezoid over decreasing x
        v = float(-np.trapezoid(precision, recall))
        if not math.isnan(v):
            auprs.append(np.nan_to_num(v))
        hit = np.nonzero(1.0 - precision <= fdr_cutoff)[0]
        if hit.size:
            r = recall[hit[0]]
            if not math.isnan(r):
                fdrs.append(np.nan_to_num(r))
    return auprs, fdrs


def aupr(targets: np.ndarray, preds: np.ndarray) -> Tuple[float, float, float, np.ndarray]:
    """Per-label PR AUC via trapezoid on the PR curve; (mean, median, var, all).
    Exact-match vectorization of the sklearn curve (see _pr_curve_one)."""
    return _summary(_aupr_fdr(targets, preds)[0])


def fdr(
    targets: np.ndarray, preds: np.ndarray, fdr_cutoff: float = 0.5
) -> Tuple[float, float, float, np.ndarray]:
    """Recall at the first PR-curve point with FDR <= cutoff; (mean, median, var, all)."""
    return _summary(_aupr_fdr(targets, preds, fdr_cutoff)[1])


def aupr_and_fdr(targets, preds, fdr_cutoff: float = 0.5):
    """(aupr summary, fdr summary) sharing one PR-curve pass — used by
    evals.compute_metrics so each epoch builds each label's curve once."""
    a, f = _aupr_fdr(targets, preds, fdr_cutoff)
    return _summary(a), _summary(f)


def mean_average_precision(targets: np.ndarray, preds: np.ndarray) -> float:
    """Macro average precision (reference: utils/metrics.py:25-26).

    Identical to sklearn.average_precision_score(average='macro'): the
    step-wise AP sum -Σ diff(recall)·precision[:-1] over each label's PR
    curve, macro-averaged (pinned exact in tests/test_metrics.py). Shares
    the vectorized PR-curve code with aupr/fdr."""
    t64 = np.asarray(targets, np.float64)
    aps = np.empty(targets.shape[1])
    for i in range(targets.shape[1]):
        precision, recall = _pr_curve_one(t64[:, i], preds[:, i])
        aps[i] = -np.sum(np.diff(recall) * precision[:-1])
    return float(aps.mean())


def subset_accuracy(targets: np.ndarray, predictions: np.ndarray, axis: int = 1) -> float:
    return float(np.mean(np.all(targets == predictions, axis=axis)))


def hamming_loss(targets: np.ndarray, predictions: np.ndarray) -> float:
    return float(np.mean(np.logical_xor(targets, predictions)))


def f1_score(
    targets: np.ndarray, predictions: np.ndarray, average: str = "micro", axis: int = 0
) -> float:
    """Micro/macro F1 from binarized predictions (reference: utils/metrics.py:65-110)."""
    tp = np.sum(targets * predictions, axis=axis).astype(np.float64)
    fp = np.sum((1 - targets) * predictions, axis=axis).astype(np.float64)
    fn = np.sum(targets * (1 - predictions), axis=axis).astype(np.float64)
    if average == "micro":
        denom = 2 * tp.sum() + fp.sum() + fn.sum()
        return float(2 * tp.sum() / denom) if denom > 0 else 0.0
    if average == "macro":
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.true_divide(2 * tp, 2 * tp + fp + fn)
        per = per[np.isfinite(per)]
        return float(per.mean()) if per.size else 0.0
    raise ValueError("average must be 'micro' or 'macro'")


def example_f1_score(targets: np.ndarray, predictions: np.ndarray) -> float:
    """Per-example F1 averaged over examples (reference: utils/metrics.py:50-63)."""
    tp = np.sum(targets * predictions, axis=1).astype(np.float64)
    denom = targets.sum(1) + predictions.sum(1)
    keep = denom > 0
    if not keep.any():
        return 0.0
    return float(np.mean(2 * tp[keep] / denom[keep]))


def roc_curve(targets: np.ndarray, preds: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) of one binary label, exactly as
    sklearn.metrics.roc_curve returns them with its defaults: thresholds
    descending from +inf, collinear points dropped (drop_intermediate), and
    NaN rates where a class is missing (sklearn warns there)."""
    t = np.asarray(targets).ravel() == 1
    p = np.asarray(preds).ravel()
    order = np.argsort(p, kind="mergesort")[::-1]
    p, t = p[order], t[order]
    idx = np.r_[np.nonzero(np.diff(p))[0], p.size - 1]
    tps = np.cumsum(t, dtype=np.float64)[idx]
    fps = 1 + idx - tps
    thresholds = p[idx]
    if len(fps) > 2:
        keep = np.nonzero(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds]
    with np.errstate(invalid="ignore", divide="ignore"):
        fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
        tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def find_optimal_cutoff(targets: np.ndarray, preds: np.ndarray) -> np.ndarray:
    """Youden-J optimal threshold per label, the first of the ROC curve's
    thresholds where tpr - fpr is largest (reference: utils/metrics.py:
    224-236). A label whose predictions are not all finite gets 0.5, where
    sklearn raises and the reference catches it."""
    cutoffs = []
    for i in range(targets.shape[1]):
        p = np.asarray(preds[:, i])
        if not np.isfinite(p).all():
            cutoffs.append(0.5)
            continue
        fpr, tpr, thresholds = roc_curve(targets[:, i], p)
        cutoffs.append(thresholds[np.argmax(tpr - fpr)])
    return np.asarray(cutoffs)
