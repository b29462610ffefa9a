"""Metric aggregation, best-tracking logger, and CSV epoch logs (port of
chromegcn_tpu/utils/evals.py; the files it writes have the JAX package's
names and formats).

Mirrors the reference's eval stack (reference: utils/evals.py:26-300):
- ``compute_metrics``: mAP + mean/median/var AUROC, AUPR, recall@50%FDR,
  optional per-label-type (TFBS / histone-mark / DNase) splits keyed on
  label-name substrings (reference: utils/evals.py:29-67).
- ``BestTracker``: best-on-valid per metric and the test value at that
  epoch (reference: utils/evals.py:122-247).
- ``EpochLogger``: `{train,valid,test}.log` CSV lines
  ``epoch,loss,mAP,meanAUC,meanAUPR,meanFDR`` (reference: utils/evals.py:297-300).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from chromegcn_tpu_torch.utils import metrics


def _label_type_indices(label_names: Sequence[str], cell_type: str):
    """TFBS / HM / DNase index split by label-name substring
    (reference: utils/evals.py:29-36)."""
    cleaned = []
    for key in label_names:
        name = key
        for junk in (
            "wgencodeawg", "unipk", "gm12878", "k562", "iggmus", "syd", "uta",
            "haib", "pcr1x", "pcr2x", "iggrab", "broad",
        ):
            name = name.replace(junk, "")
        name = name.replace("tfbs", "tfbs_").split("sc")[0]
        cleaned.append(name)
    tfbs = [i for i, n in enumerate(cleaned) if "tfbs" in n]
    hm_key = "e116-h" if cell_type == "GM12878" else "e123-h"
    hm = [i for i, n in enumerate(cleaned) if hm_key in n]
    dnase = [i for i, n in enumerate(cleaned) if "dnase" in n]
    return {"tfbs": tfbs, "hm": hm, "dnase": dnase}


def compute_metrics(
    predictions: np.ndarray,
    targets: np.ndarray,
    loss: float,
    elapsed: float = 0.0,
    label_names: Optional[Sequence[str]] = None,
    cell_type: str = "GM12878",
    per_label_type: bool = False,
    br_threshold: float = 0.5,
) -> Dict[str, object]:
    """Build the metrics dict (reference: utils/evals.py:26-120)."""
    predictions = np.asarray(predictions, dtype=np.float64)
    targets = np.asarray(targets, dtype=np.float64)
    out: Dict[str, object] = {}

    if per_label_type and label_names is not None:
        groups = _label_type_indices(label_names, cell_type)
        for gname, idx in groups.items():
            if not idx:
                continue
            p, t = predictions[:, idx], targets[:, idx]
            out[f"{gname}_meanAUC"] = metrics.auroc(t, p)[0]
            # one shared PR-curve pass per group, same as the global metrics
            (aupr_g, _, _, _), (fdr_g, _, _, _) = metrics.aupr_and_fdr(t, p)
            out[f"{gname}_meanAUPR"] = aupr_g
            out[f"{gname}_meanFDR"] = fdr_g

    mean_auc, median_auc, _, all_auc = metrics.auroc(targets, predictions)
    # one PR-curve pass feeds both AUPR and FDR (metrics.aupr_and_fdr)
    (
        (mean_aupr, median_aupr, _, all_aupr),
        (mean_fdr, median_fdr, _, all_fdr),
    ) = metrics.aupr_and_fdr(targets, predictions)
    out["mAP"] = metrics.mean_average_precision(targets, predictions)
    out["meanAUC"] = mean_auc
    out["medianAUC"] = median_auc
    out["allAUC"] = all_auc
    out["meanAUPR"] = mean_aupr
    out["medianAUPR"] = median_aupr
    out["allAUPR"] = all_aupr
    out["meanFDR"] = mean_fdr
    out["medianFDR"] = median_fdr
    out["allFDR"] = all_fdr

    binarized = (predictions >= br_threshold).astype(np.float64)
    out["ACC"] = metrics.subset_accuracy(targets, binarized)
    out["HA"] = 1.0 - metrics.hamming_loss(targets, binarized)
    out["ebF1"] = metrics.example_f1_score(targets, binarized)
    out["miF1"] = metrics.f1_score(targets, binarized, average="micro")
    out["maF1"] = metrics.f1_score(targets, binarized, average="macro")

    out["loss"] = float(loss)
    out["time"] = float(elapsed)
    return out


def selection_score(valid_metrics: Dict[str, object]) -> float:
    """Model-selection criterion (reference: runner.py:46 — meanAUPR is
    counted twice, a published quirk we reproduce for selection parity)."""
    return (
        float(valid_metrics["meanAUPR"]) * 2.0 + float(valid_metrics["meanFDR"])
    )


class BestTracker:
    """Best-on-valid tracking with the corresponding test metrics
    (reference: utils/evals.py:122-247)."""

    _SCALARS = (
        "ACC", "HA", "ebF1", "miF1", "maF1",
        "meanAUC", "medianAUC", "meanAUPR", "medianAUPR", "meanFDR", "medianFDR",
        "mAP",
    )

    def __init__(self):
        self.best_valid = {k: 0.0 for k in self._SCALARS}
        self.best_valid["loss"] = float("inf")
        self.best_test = {k: 0.0 for k in self._SCALARS}
        self.best_test["loss"] = float("inf")
        self.best_test["epoch"] = 0

    def evaluate(self, valid_metrics, test_metrics, epoch: int):
        if valid_metrics is None:
            valid_metrics = test_metrics
        for metric, value in valid_metrics.items():
            if metric not in self.best_valid or not np.isscalar(value):
                continue
            if metric == "loss":
                if value < self.best_valid["loss"]:
                    self.best_valid["loss"] = value
                    self.best_test["loss"] = test_metrics["loss"]
                continue
            if value >= self.best_valid[metric]:
                self.best_valid[metric] = value
                self.best_test[metric] = test_metrics[metric]
                if metric == "ACC":
                    self.best_test["epoch"] = epoch
        return self.best_valid, self.best_test

    def summary(self) -> str:
        return (
            f"best meanAUC:  {self.best_test['meanAUC']:.4f}\n"
            f"best meanAUPR: {self.best_test['meanAUPR']:.4f}\n"
            f"best meanFDR:  {self.best_test['meanFDR']:.4f}"
        )


class EpochLogger:
    """Per-epoch CSV logs + best prediction snapshots."""

    def __init__(self, run_dir: str, append: bool = False):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        os.makedirs(os.path.join(run_dir, "epochs"), exist_ok=True)
        if not append:  # resume passes append=True to keep prior epochs
            for split in ("train", "valid", "test"):
                open(os.path.join(run_dir, f"{split}.log"), "w").close()
        self.best_valid_loss = float("inf")
        self.best_valid_metric = 0.0
        self.best_loss_epoch = 0
        # resume restores the best-score state too: without it the first
        # resumed epoch always "improves" (best starts at inf/0) and can
        # overwrite the pre-resume best snapshots/checkpoint with a worse
        # epoch (ADVICE r4)
        best_path = os.path.join(run_dir, "best.json")
        if append and os.path.exists(best_path):
            with open(best_path) as f:
                best = json.load(f)
            self.best_valid_loss = float(best["valid_loss"])
            self.best_valid_metric = float(best["valid_metric"])
            self.best_loss_epoch = int(best["loss_epoch"])

    def _persist_best(self) -> None:
        with open(os.path.join(self.run_dir, "best.json"), "w") as f:
            json.dump(
                {
                    "valid_loss": self.best_valid_loss,
                    "valid_metric": self.best_valid_metric,
                    "loss_epoch": self.best_loss_epoch,
                },
                f,
            )

    def log(self, split: str, epoch: int, loss: float, m: Optional[Dict]) -> None:
        if m is None:
            return
        with open(os.path.join(self.run_dir, f"{split}.log"), "a") as f:
            f.write(
                f"{epoch},{loss},{m['mAP']},{m['meanAUC']},{m['meanAUPR']},{m['meanFDR']}\n"
            )

    def maybe_snapshot(
        self, epoch: int, valid_loss: float, valid_score: float,
        valid_preds, valid_targs, test_preds, test_targs,
    ) -> bool:
        """Save pred/target snapshots on valid-loss / valid-score improvements
        (reference: utils/evals.py:275-289). Returns True if the metric
        snapshot was updated (signals checkpoint-worthy epoch)."""
        ep = os.path.join(self.run_dir, "epochs")
        updated = False
        if valid_loss < self.best_valid_loss:
            self.best_valid_loss = valid_loss
            self.best_loss_epoch = epoch
            updated = True
            np.savez_compressed(
                os.path.join(ep, "best_loss.npz"),
                valid_preds=valid_preds, valid_targets=valid_targs,
                test_preds=test_preds, test_targets=test_targs,
            )
        improved = valid_score > self.best_valid_metric
        if improved:
            self.best_valid_metric = valid_score
            updated = True
            np.savez_compressed(
                os.path.join(ep, "best_metrics.npz"),
                valid_preds=valid_preds, valid_targets=valid_targs,
                test_preds=test_preds, test_targets=test_targs,
            )
        if updated:
            self._persist_best()
        return improved
