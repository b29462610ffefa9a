"""Binary cross-entropy with logits, row-masked for padding (port of
chromegcn_tpu/train/loss.py; reference: finetune.py:45, mean reduction).

With a process group (each rank holding its own rows) the masked sum and
the count are all-reduced over it, so every rank holds the global mean. Its
backward passes the cotangent through: every rank differentiates the same
loss from 1, so each gets its own rows' part of the gradient, and the steps
sum the parameters' gradients over the group (``parallel/mesh.py``).

The masked sum is ``ops/bce_fused.py:masked_bce_sum``: two hand-written
kernels for f32 logits on the card, the plain torch formula on the CPU and
in float64."""

from __future__ import annotations

from typing import Optional

import torch

from chromegcn_tpu_torch.ops.bce_fused import masked_bce_sum
from chromegcn_tpu_torch.parallel.mesh import reduce_replicated


def bce_with_logits(
    logits: torch.Tensor,
    targets: torch.Tensor,
    row_mask: Optional[torch.Tensor] = None,
    group=None,
) -> torch.Tensor:
    """Mean BCE-with-logits over valid rows, in the stable form
    max(x,0) - x*z + log1p(exp(-|x|)), in f32 (or float64 for float64
    logits); the targets are converted to that dtype, once.

    Args:
      logits: (N, L) raw scores.
      targets: (N, L) {0,1} labels (any float/int dtype).
      row_mask: optional (N,) bool; False rows are excluded from the mean.
      group: optional process group over which the rows are sharded.
    """
    x = logits.to(torch.promote_types(logits.dtype, torch.float32))
    z = targets.to(x.dtype)
    if row_mask is None:
        row_mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    m = row_mask.to(x.dtype)
    # the masked sum and the count, summed over the group's ranks if any
    num, count = reduce_replicated(torch.stack([masked_bce_sum(x, z, m), m.sum()]), group)
    return num / (count * x.shape[1]).clamp(min=1.0)
