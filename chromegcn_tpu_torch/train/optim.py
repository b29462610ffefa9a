"""Optimizer and LR-schedule factories (port of chromegcn_tpu/train/optim.py).

Reference: utils/util_methods.py:11-19 —
- Adam(betas=(0.9, 0.98), eps=1e-8, lr)
- SGD(lr, momentum=0.9, weight_decay=1e-6): torch adds the L2 term to the
  gradient before momentum, which is what the reference's optax chain
  (add_decayed_weights, trace, scale_by_learning_rate) spells out;
and the per-epoch StepLR(step_size=100, gamma=0.5) gated on ``lr_decay2 > 0``.
"""

from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(
    name: str, lr: float, params: Iterable[torch.nn.Parameter]
) -> torch.optim.Optimizer:
    name = name.lower()
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.98), eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9, weight_decay=1e-6)
    raise ValueError(f"unknown optimizer {name!r}")


def steplr_lr(base_lr: float, epoch: int, enabled: bool,
              step_size: int = 100, gamma: float = 0.5) -> float:
    """StepLR stepped once per epoch at epoch start (reference runner.py:33),
    so epoch e uses gamma^(e // step_size)."""
    if not enabled:
        return base_lr
    return base_lr * (gamma ** (epoch // step_size))


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer
