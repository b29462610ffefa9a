"""The port's batched host metrics (``utils/metrics.py:label_scores``, through
``utils/evals.py:compute_metrics``) against the per-label numpy loops they
replaced, kept here as the oracle, on the CPU and on the card.

Imports no JAX. The card's machine has no JAX, which tests/conftest.py
imports, so run it there without the conftest: ``python -m pytest
--noconftest tests/test_torch_metrics.py``.
"""

import math

import numpy as np
import pytest
import torch

from chromegcn_tpu_torch.utils import metrics
from chromegcn_tpu_torch.utils.evals import _label_type_indices, compute_metrics

# ---------------------------------------------------------------------------
# the oracle: one sort and one curve per label, in float64
# ---------------------------------------------------------------------------


def _summary(out):
    arr = np.asarray(out)
    if arr.size == 0:
        return float("nan"), float("nan"), float("nan"), arr
    return float(arr.mean()), float(np.median(arr)), float(arr.var()), arr


def _pr_curve_one(t, p):
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
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0]


def _auroc(targets, preds):
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
        mid = (starts + ends - 1) / 2.0 + 1.0
        ranks = np.empty(n)
        ranks[order] = np.repeat(mid, ends - starts)
        u = ranks[t > 0].sum() - npos * (npos + 1) / 2.0
        v = u / (npos * nneg)
        if not math.isnan(v):
            out.append(v)
    return _summary(out)


def _aupr_fdr(targets, preds, fdr_cutoff=0.5):
    auprs, fdrs = [], []
    t64 = np.asarray(targets, np.float64)
    for i in range(targets.shape[1]):
        precision, recall = _pr_curve_one(t64[:, i], preds[:, i])
        v = float(-np.trapezoid(precision, recall))
        if not math.isnan(v):
            auprs.append(np.nan_to_num(v))
        hit = np.nonzero(1.0 - precision <= fdr_cutoff)[0]
        if hit.size:
            r = recall[hit[0]]
            if not math.isnan(r):
                fdrs.append(np.nan_to_num(r))
    return _summary(auprs), _summary(fdrs)


def _mean_average_precision(targets, preds):
    t64 = np.asarray(targets, np.float64)
    aps = np.empty(targets.shape[1])
    for i in range(targets.shape[1]):
        precision, recall = _pr_curve_one(t64[:, i], preds[:, i])
        aps[i] = -np.sum(np.diff(recall) * precision[:-1])
    return float(aps.mean())


def _f1_score(targets, predictions, average):
    tp = np.sum(targets * predictions, axis=0).astype(np.float64)
    fp = np.sum((1 - targets) * predictions, axis=0).astype(np.float64)
    fn = np.sum(targets * (1 - predictions), axis=0).astype(np.float64)
    if average == "micro":
        denom = 2 * tp.sum() + fp.sum() + fn.sum()
        return float(2 * tp.sum() / denom) if denom > 0 else 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        per = np.true_divide(2 * tp, 2 * tp + fp + fn)
    per = per[np.isfinite(per)]
    return float(per.mean()) if per.size else 0.0


def _example_f1_score(targets, predictions):
    tp = np.sum(targets * predictions, axis=1).astype(np.float64)
    denom = targets.sum(1) + predictions.sum(1)
    keep = denom > 0
    if not keep.any():
        return 0.0
    return float(np.mean(2 * tp[keep] / denom[keep]))


def oracle(predictions, targets, loss, elapsed=0.0, label_names=None,
           cell_type="GM12878", per_label_type=False, br_threshold=0.5):
    predictions = np.asarray(predictions, dtype=np.float64)
    targets = np.asarray(targets, dtype=np.float64)
    out = {}
    if per_label_type and label_names is not None:
        for gname, idx in _label_type_indices(label_names, cell_type).items():
            if not idx:
                continue
            p, t = predictions[:, idx], targets[:, idx]
            out[f"{gname}_meanAUC"] = _auroc(t, p)[0]
            (aupr_g, _, _, _), (fdr_g, _, _, _) = _aupr_fdr(t, p)
            out[f"{gname}_meanAUPR"] = aupr_g
            out[f"{gname}_meanFDR"] = fdr_g
    out["meanAUC"], out["medianAUC"], _, out["allAUC"] = _auroc(targets, predictions)
    (
        (out["meanAUPR"], out["medianAUPR"], _, out["allAUPR"]),
        (out["meanFDR"], out["medianFDR"], _, out["allFDR"]),
    ) = _aupr_fdr(targets, predictions)
    out["mAP"] = _mean_average_precision(targets, predictions)
    binarized = (predictions >= br_threshold).astype(np.float64)
    out["ACC"] = float(np.mean(np.all(targets == binarized, axis=1)))
    out["HA"] = 1.0 - float(np.mean(np.logical_xor(targets, binarized)))
    out["ebF1"] = _example_f1_score(targets, binarized)
    out["miF1"] = _f1_score(targets, binarized, "micro")
    out["maF1"] = _f1_score(targets, binarized, "macro")
    out["loss"] = float(loss)
    out["time"] = float(elapsed)
    return out


# ---------------------------------------------------------------------------
# the batched pass against it
# ---------------------------------------------------------------------------


def _world(rows, labels, rate, ties, seed):
    """(preds, targets): label 1 has no positive (the degenerate PR curve,
    no AUROC), label 2 no negative (no AUROC); ``ties`` rounds the scores
    to 1/ties."""
    rng = np.random.default_rng(seed)
    targets = (rng.random((rows, labels)) < rate).astype(np.float32)
    targets[:, 1] = 0.0
    targets[:, 2] = 1.0
    preds = rng.random((rows, labels))
    if ties:
        preds = np.round(preds * ties) / ties
    return preds, targets


def _names(labels):
    return [f"wgencodeawgtfbs{i}" if i % 3 == 0 else f"e116-h3k{i}" if i % 3 == 1
            else f"dnase{i}" for i in range(labels)]


def _assert_same(ours, ref):
    assert set(ours) == set(ref)
    for key, value in ref.items():
        if key.startswith("all"):
            assert isinstance(ours[key], np.ndarray), key
            assert ours[key].shape == value.shape, key
        else:
            assert type(ours[key]) is float, key
        np.testing.assert_allclose(ours[key], value, rtol=0, atol=1e-12, err_msg=key)


# name: rows, labels, positive rate, ties, labels per column block (None:
# the module's budget)
CASES = {
    # heavy ties; 39 labels with an AUROC, 41 with a PR curve: odd medians
    "ties_odd": (700, 41, 0.05, 50, None),
    # 40 and 42: even medians
    "ties_even": (700, 42, 0.3, 50, None),
    # three score values: nearly every row in a tie
    "coarse": (300, 9, 0.2, 2, None),
    # distinct scores over eight column blocks of four labels
    "blocks": (900, 30, 0.05, None, 4),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(CASES))
def test_compute_metrics_matches_the_per_label_loops(case, dtype, monkeypatch):
    rows, labels, rate, ties, per_block = CASES[case]
    if per_block is not None:
        monkeypatch.setattr(metrics, "BLOCK_BYTES", rows * metrics.ENTRY_BYTES * per_block)
    preds, targets = _world(rows, labels, rate, ties, seed=len(case))
    preds = preds.astype(dtype)
    names = _names(labels)
    blocks = metrics.COUNTS["blocks"]
    ours = compute_metrics(preds, targets, 0.3, 0.25, label_names=names, per_label_type=True)
    ran = metrics.COUNTS["blocks"] - blocks
    assert ran == -(-labels // metrics.block_labels(rows))
    if per_block is not None:
        assert ran == 8
    _assert_same(ours, oracle(preds, targets, 0.3, 0.25, label_names=names,
                              per_label_type=True))


card = pytest.mark.skipif(not torch.cuda.is_available(),
                          reason="needs a CUDA card: torch.cuda.is_available() is False")


@card
@pytest.mark.parametrize("ties", [None, 50], ids=["distinct", "ties"])
def test_the_card_matches_the_per_label_loops(ties):
    """The epoch's train split as the benchmark makes it: 12,000 x 919
    float32 predictions, 5% positives, in 14 column blocks, against the
    per-label loops and the CPU path. The card's working set stays within
    one column block's budget."""
    rng = np.random.default_rng(15)
    preds = rng.random((12_000, 919), dtype=np.float32)
    if ties:
        preds = (np.round(preds * ties) / ties).astype(np.float32)
    targets = (rng.random(preds.shape) < 0.05).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ours = compute_metrics(preds, targets, 0.3, device="cuda")
    working = torch.cuda.max_memory_allocated() - base
    _assert_same(ours, oracle(preds, targets, 0.3))
    _assert_same(ours, compute_metrics(preds, targets, 0.3))
    per_block = metrics.block_labels(preds.shape[0])
    print(f"working set {working} bytes, {working / (per_block * preds.shape[0]):.1f} "
          f"bytes a (row, label) entry of a {per_block}-label block")
    assert working <= metrics.BLOCK_BYTES
