"""Binary cross-entropy with logits, row-masked for padding (port of
chromegcn_tpu/train/loss.py; reference: finetune.py:45, mean reduction)."""

from __future__ import annotations

from typing import Optional

import torch


def bce_with_logits(
    logits: torch.Tensor,
    targets: torch.Tensor,
    row_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean BCE-with-logits over valid rows, in the stable form
    max(x,0) - x*z + log1p(exp(-|x|)), in f32 (or float64 for float64
    logits).

    Args:
      logits: (N, L) raw scores.
      targets: (N, L) {0,1} labels (any float/int dtype).
      row_mask: optional (N,) bool; False rows are excluded from the mean.
    """
    x = logits.to(torch.promote_types(logits.dtype, torch.float32))
    z = targets.to(x.dtype)
    per_elem = x.clamp(min=0.0) - x * z + torch.log1p(torch.exp(-x.abs()))
    if row_mask is None:
        return per_elem.mean()
    m = row_mask.to(x.dtype)[:, None]
    denom = (m.sum() * per_elem.shape[1]).clamp(min=1.0)
    return (per_elem * m).sum() / denom
