"""Masked BatchNorm with torch BatchNorm1d semantics (port of
chromegcn_tpu/models/norm.py).

Normalizes with the *biased* batch variance, updates ``running_var`` with
the *unbiased* one, momentum 0.1, and excludes masked (padding) rows from
the statistics: chromosome node tensors are padded to bucketed shapes, and
padding must not leak into mean/var. The statistics are taken in f32, or in
the input's type where it is wider (float64 runs stay float64).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm over all leading axes of a (..., C) input, with an optional
    (...,) bool validity mask broadcast over extra leading axes (e.g. the
    strand axis of (N, S, C)). Masked rows do not enter the statistics; they
    are normalized with the valid rows' stats and dropped downstream."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self) -> None:
        """Identity: weight 1, bias 0, running mean 0 and variance 1."""
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(
        self,
        x: torch.Tensor,
        use_running_average: bool,
        mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            reduce_axes = tuple(range(x.dim() - 1))
            if mask is None:
                n = torch.tensor(float(x[..., 0].numel()), dtype=x32.dtype, device=x.device)
                mean = x32.mean(dim=reduce_axes)
                var = (x32 - mean).square().mean(dim=reduce_axes)
            else:
                m = mask.to(x32.dtype)
                m = m.reshape(m.shape + (1,) * (x.dim() - 1 - m.dim()))
                m = m.expand(x.shape[:-1])[..., None]
                n = m.sum().clamp(min=1.0)
                mean = (x32 * m).sum(dim=reduce_axes) / n
                var = ((x32 - mean).square() * m).sum(dim=reduce_axes) / n
            with torch.no_grad():
                # torch updates running_var with the unbiased estimate
                unbiased = var * (n / (n - 1.0).clamp(min=1.0))
                self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * unbiased)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)
