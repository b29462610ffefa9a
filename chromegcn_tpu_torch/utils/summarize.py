"""Dataset label statistics (port of chromegcn_tpu/utils/summarize.py;
reference: utils/util_methods.py:24-74)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from chromegcn_tpu_torch.data.loader import WindowDataset


def summarize_data(splits: Dict[str, WindowDataset], verbose=print) -> Dict[str, float]:
    """Counts, labels-per-sample, samples-per-label, label correlation."""
    train, valid = splits["train"], splits["valid"]
    stats = {
        "num_train": len(train),
        "num_valid": len(valid),
        "num_test": len(splits["test"]) if "test" in splits else 0,
    }
    labels = np.concatenate(
        [train.targets.astype(np.float64), valid.targets.astype(np.float64)]
    )
    per_sample = labels.sum(1)
    per_label = labels.sum(0)
    stats.update(
        mean_labels_per_sample=float(per_sample.mean()),
        median_labels_per_sample=float(np.median(per_sample)),
        max_labels_per_sample=float(per_sample.max()),
        mean_samples_per_label=float(per_label.mean()),
        median_samples_per_label=float(np.median(per_label)),
        max_samples_per_label=float(per_label.max()),
    )
    with np.errstate(invalid="ignore"):
        stats["label_pearson"] = np.corrcoef(train.targets.astype(np.float64).T)
    for key, val in stats.items():
        if np.isscalar(val):
            verbose(f"{key}: {val}")
    return stats
