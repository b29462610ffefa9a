"""Evaluation metrics: per-label AUROC / AUPR / recall-at-50%-FDR, mAP, F1s
(port of chromegcn_tpu/utils/metrics.py).

``label_scores`` computes all of them for a (rows, labels) matrix of
predictions in one pass on a torch device, the caller's card or the CPU:
the labels go through in column blocks, each block's columns get one sort
by descending score, and one cumulative sum of the sorted targets gives
every curve point of every label in the block. Ratios, areas and sums are
float64 on every device. The semantics are the reference's sklearn ones
(reference: utils/metrics.py:25-303; the JAX package pins them to 1e-12
against sklearn in tests/test_metrics.py; tests/test_torch_cli.py pins
``compute_metrics`` and tests/test_torch_analysis.py the per-label functions
to the JAX package's), including:
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
  and ``analysis/plots.py`` read; ``_pr_curve_one``, one label's
  precision-recall curve, which ``analysis/`` reads.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from chromegcn_tpu_torch import DeviceLike

# device memory one column block of ``label_scores`` may take
BLOCK_BYTES = 64 << 20
# device bytes one (row, label) entry of a block holds at the block's peak
ENTRY_BYTES = 80

# labels scored and column blocks run by ``label_scores`` in this process;
# the runner's ``metrics`` spans record their growth (``profiling.span``'s
# counters)
COUNTS = {"labels": 0, "blocks": 0}


def block_labels(rows: int) -> int:
    """Labels in one column block over ``rows`` rows: as many as
    BLOCK_BYTES holds, at least one."""
    return max(1, BLOCK_BYTES // (max(rows, 1) * ENTRY_BYTES))


def summary(values) -> Tuple[float, float, float, np.ndarray]:
    """(mean, median, var, values) of a metric's per-label values."""
    arr = np.asarray(values)
    if arr.size == 0:
        return float("nan"), float("nan"), float("nan"), arr
    return float(arr.mean()), float(np.median(arr)), float(arr.var()), arr


class LabelScores(NamedTuple):
    """One pass over a (rows, labels) matrix, on the host: per-label
    vectors, and the binarised predictions' counts."""

    auc: np.ndarray     # AUROC, NaN for a label with one class
    aupr: np.ndarray
    fdr: np.ndarray     # recall at the first PR point from full recall with FDR <= the cutoff
    ap: np.ndarray      # average precision
    tp: np.ndarray      # per label, of the predictions binarised at the threshold
    fp: np.ndarray
    fn: np.ndarray
    exact_rows: int     # rows with every label right
    wrong: int          # (row, label) entries wrong
    example_f1: float   # per-row F1, averaged over the rows with a positive target or call


def _columns(a: np.ndarray, lo: int, hi: int, device: torch.device) -> torch.Tensor:
    """Columns lo:hi of a (rows, labels) array as a (labels, rows) tensor.
    torch transposes the strided columns on the host's threads: numpy's
    one-threaded transposed copy took twice as long at 12,000 to 400,000
    rows on the H100's host, and a row-wise copy transposed on the device
    slows down as the blocks narrow."""
    return torch.from_numpy(a[:, lo:hi]).T.contiguous().to(device)


def _curves(keys: torch.Tensor, pos: torch.Tensor, fdr_cutoff: float):
    """(AUROC, AUPR, FDR, AP) of each label of a block from ``keys``, its
    (labels, rows) scores, and ``pos``, its bool targets. Each tensor is
    freed as soon as it is spent: ENTRY_BYTES counts what is left at the
    peak."""
    labels, rows = keys.shape
    f64 = torch.float64
    # Every quantity below depends only on the tie groups (runs of equal
    # scores), as midranks or distinct thresholds, so a stable sort is not
    # needed: rows tied in score may leave it in any order.
    keys, order = torch.sort(keys, dim=1, descending=True)
    tps = pos.gather(1, order).cumsum(1)  # int64: true positives down to each row
    del order
    last = torch.ones_like(pos)  # each tie group's last row: a curve point
    last[:, :-1] = keys[:, 1:] != keys[:, :-1]
    del keys
    at = torch.arange(rows, device=pos.device)
    # at a group's last row: the previous group's last row, -1 for the first
    prev = torch.where(last, at, -1).cummax(1).values
    prev = torch.cat([prev.new_full((labels, 1), -1), prev[:, :-1]], 1)
    tps_prev = torch.where(prev >= 0, tps.gather(1, prev.clamp(min=0)), 0)
    npos = tps[:, -1:]
    # each negative counts the positives above its group twice, those tied
    # with it once: 2U = Σ over groups of negatives x (tps_prev + tps)
    neg = (at - prev) - (tps - tps_prev)
    twice_u = torch.where(last, neg * (tps_prev + tps), 0).sum(1)
    del neg
    pairs = npos[:, 0] * (rows - npos[:, 0])  # AUROC = U / (positives x negatives)
    auc = torch.where(pairs > 0, twice_u.to(f64) / (2 * pairs).to(f64), float("nan"))
    precision_prev = torch.where(prev >= 0, tps_prev.to(f64) / (prev + 1).to(f64), 1.0)
    del prev
    total = npos.to(f64)
    recall_prev = tps_prev / total
    del tps_prev
    recall = tps / total
    precision = tps.to(f64) / (at + 1).to(f64)
    del tps
    gain = recall - recall_prev  # the recall a group adds, 0 past full recall
    del recall_prev
    aupr = torch.where(last, gain * (precision + precision_prev) / 2.0, 0.0).sum(1)
    ap = torch.where(last, gain * precision, 0.0).sum(1)
    del gain, precision_prev
    # the first point from full recall where FDR <= cutoff, else the curve's
    # (1, 0) end, recall 0. The curve is cut at its first full-recall point,
    # but the points past it have recall 1 too, so the last point with
    # FDR <= cutoff has the recall of the first on the cut curve.
    hit = torch.where(last & (1.0 - precision <= fdr_cutoff), at, -1).amax(1, keepdim=True)
    fdr = torch.where(hit >= 0, recall.gather(1, hit.clamp(min=0)), 0.0)[:, 0]
    empty = npos[:, 0] == 0  # sklearn's degenerate curve ([0, 1], [1, 0])
    return auc, torch.where(empty, 0.5, aupr), fdr, torch.where(empty, 0.0, ap)


def label_scores(
    targets: np.ndarray,
    preds: np.ndarray,
    *,
    threshold: float = 0.5,
    fdr_cutoff: float = 0.5,
    device: DeviceLike = "cpu",
) -> LabelScores:
    """Every per-label metric of (rows, labels) 0/1 ``targets`` and scores
    ``preds`` in one pass on ``device``: column blocks of ``block_labels``
    labels, each copied to the device, sorted once and scanned once; the
    predictions binarised at ``threshold`` are counted in the same pass.
    Scores are sorted in the dtype they come in (float32 or float64; others
    as float64): widening float32 is exact, so the ties are float64's."""
    device = torch.device(device)
    keys = np.asarray(preds)
    if keys.dtype not in (np.float32, np.float64):
        keys = keys.astype(np.float64)
    targets = np.asarray(targets)
    if keys.shape != targets.shape or keys.ndim != 2:
        raise ValueError(f"preds {keys.shape} and targets {targets.shape} must be one "
                         "(rows, labels) shape")
    rows, labels = keys.shape
    step = block_labels(rows)
    f64 = torch.float64
    row_wrong, row_tp, row_size = (
        torch.zeros(rows, dtype=torch.int64, device=device) for _ in range(3))
    parts = []
    for lo in range(0, labels, step):
        hi = min(lo + step, labels)
        block = _columns(keys, lo, hi, device)
        pos = _columns(targets, lo, hi, device) > 0
        called = block.to(f64) >= threshold
        both = pos & called
        tp = both.sum(1)
        row_wrong += (pos != called).sum(0)
        row_tp += both.sum(0)
        row_size += pos.sum(0) + called.sum(0)
        counts = (tp, called.sum(1) - tp, pos.sum(1) - tp)
        del called, both
        parts.append(_curves(block, pos, fdr_cutoff) + counts)
        del block, pos
    COUNTS["labels"] += labels
    COUNTS["blocks"] += len(parts)
    out = [torch.cat(p).cpu().numpy() for p in zip(*parts)]
    keep = row_size > 0
    f1 = torch.where(keep, (2 * row_tp).to(f64) / row_size.clamp(min=1).to(f64), 0.0).sum()
    n_keep = int(keep.sum())
    return LabelScores(
        *out,
        exact_rows=int((row_wrong == 0).sum()),
        wrong=int(row_wrong.sum()),
        example_f1=float(f1) / n_keep if n_keep else 0.0,
    )


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

    Computed as the tie-corrected Mann-Whitney U statistic, identical to
    sklearn's trapezoidal roc_auc_score — pinned exact against sklearn incl.
    heavy ties in tests/test_metrics.py. Single-class labels are skipped
    (sklearn raises there; the reference swallows it)."""
    auc = label_scores(targets, preds).auc
    return summary(auc[~np.isnan(auc)])


def aupr(targets: np.ndarray, preds: np.ndarray) -> Tuple[float, float, float, np.ndarray]:
    """Per-label PR AUC via trapezoid on the PR curve; (mean, median, var, all)."""
    return summary(label_scores(targets, preds).aupr)


def fdr(
    targets: np.ndarray, preds: np.ndarray, fdr_cutoff: float = 0.5
) -> Tuple[float, float, float, np.ndarray]:
    """Recall at the first PR-curve point with FDR <= cutoff; (mean, median, var, all)."""
    return summary(label_scores(targets, preds, fdr_cutoff=fdr_cutoff).fdr)


def aupr_and_fdr(targets, preds, fdr_cutoff: float = 0.5):
    """(aupr summary, fdr summary) from one pass."""
    s = label_scores(targets, preds, fdr_cutoff=fdr_cutoff)
    return summary(s.aupr), summary(s.fdr)


def mean_average_precision(targets: np.ndarray, preds: np.ndarray) -> float:
    """Macro average precision (reference: utils/metrics.py:25-26).

    Identical to sklearn.average_precision_score(average='macro'): the
    step-wise AP sum -Σ diff(recall)·precision[:-1] over each label's PR
    curve, macro-averaged (pinned exact in tests/test_metrics.py)."""
    return float(label_scores(targets, preds).ap.mean())


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
