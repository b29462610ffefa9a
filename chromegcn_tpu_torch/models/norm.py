"""Masked BatchNorm with torch BatchNorm1d semantics (port of
chromegcn_tpu/models/norm.py).

Normalizes with the *biased* batch variance, updates ``running_var`` with
the *unbiased* one, momentum 0.1, and excludes masked (padding) rows from
the statistics: chromosome node tensors are padded to bucketed shapes, and
padding must not leak into mean/var. The statistics are taken in f32, or in
the input's type where it is wider (float64 runs stay float64).

With a process group (``group=``, each rank holding its own rows) the
masked sums and the count are all-reduced over it, then the squared
deviations from the global mean: the statistics are the global batch's, as
GSPMD gives the reference's BatchNorm without being asked. The all-reduce's
backward sums every rank's cotangent (``parallel/mesh.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from chromegcn_tpu_torch.parallel.mesh import all_reduce_sum


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
        group=None,
    ) -> torch.Tensor:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            # the valid rows' sums and count, then their squared deviations;
            # with a group, each summed over its ranks (a no-op without one)
            reduce_axes = tuple(range(x.dim() - 1))
            if mask is None:
                m = torch.ones(x.shape[:-1] + (1,), dtype=x32.dtype, device=x.device)
            else:
                m = mask.to(x32.dtype)
                m = m.reshape(m.shape + (1,) * (x.dim() - 1 - m.dim()))
                m = m.expand(x.shape[:-1])[..., None]
            sums = all_reduce_sum(
                torch.cat([(x32 * m).sum(dim=reduce_axes), m.sum().reshape(1)]), group)
            n = sums[-1].clamp(min=1.0)
            mean = sums[:-1] / n
            var = all_reduce_sum(((x32 - mean).square() * m).sum(dim=reduce_axes), group) / n
            with torch.no_grad():
                # torch updates running_var with the unbiased estimate
                unbiased = var * (n / (n - 1.0).clamp(min=1.0))
                self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * unbiased)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class GroupBatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` whose training-mode statistics are the whole
    batch's across ``group``, each rank holding its rows: data-parallel
    pretraining, where GSPMD gives the reference's BatchNorm the global
    batch. The sums and the count, then the squared deviations, are
    all-reduced with a backward that sums every rank's cotangent
    (``torch.nn.SyncBatchNorm`` refuses CPU tensors). The running
    statistics keep the window models' convention: biased variance to
    normalise, unbiased into ``running_var``, momentum 0.1."""

    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.group is None:
            return super().forward(x)
        axes = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        count = torch.full((1,), x.numel() // x.shape[1], dtype=x.dtype, device=x.device)
        sums = all_reduce_sum(torch.cat([x.sum(axes), count]), self.group)
        n = sums[-1]
        mean = sums[:-1] / n
        centred = x - mean.view(shape)
        var = all_reduce_sum(centred.square().sum(axes), self.group) / n
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(
                self.momentum * var * (n / (n - 1.0).clamp(min=1.0)))
        y = centred * torch.rsqrt(var + self.eps).view(shape)
        return y * self.weight.view(shape) + self.bias.view(shape)


def sync_batch_norm(model: nn.Module, group) -> nn.Module:
    """Every ``nn.BatchNorm1d`` of ``model`` takes its training statistics
    over ``group`` (in place; its parameters and buffers stay the same
    objects). Returns the model."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm1d):
            m.__class__ = GroupBatchNorm1d
            m.group = group
    return model
