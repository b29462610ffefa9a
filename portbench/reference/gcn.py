"""Plain PyTorch reference of the ChromeGCN chromosome step (Lanchantin & Qi,
Bioinformatics 2020; the recipe of https://github.com/QData/ChromeGCN
README.md:45), written from the configuration alone. It imports nothing of
the program.

Per strand, over one chromosome's valid windows, with the row-normalised
Hi-C adjacency A = D^-1 (B + I) (B the binarised symmetric contacts):

    z_l = tanh(A (x W_l) + b_l)        g_l = sigmoid(z_l w_l + c_l)
    x   = (1 - g_l) x + g_l z_l        (dropout after layer 1)
    h   = dropout(BN(relu(x)))         BatchNorm over the valid rows

then the head once over the strands' mean, ``out((h_f + h_r) / 2)``, and the
mean binary cross-entropy with logits over rows and labels. Dropout keeps a
value with probability 1 - p and scales it by 1 / (1 - p); its masks are
Bernoulli draws of shape (padded rows, d), float32, from one generator, in
the order the forward meets them (strand f, then r; layer 1, then the
head's), as the program draws them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def param_specs(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, std) of every trained parameter, under the
    reference torch model's names; kind 'normal', 'ones' or 'zeros'."""
    d, c = cfg["nhid"], cfg["nclass"]
    specs = []
    for layer in range(1, cfg["layers"] + 1):
        specs += [
            (f"GC{layer}.weight", (d, d), "normal", 0.02 * math.sqrt(2.0 / (d + d))),
            (f"GC{layer}.bias", (d,), "zeros", 0.0),
            (f"W{layer}.weight", (1, d), "normal", math.sqrt(1.0 / d)),
            (f"W{layer}.bias", (1,), "zeros", 0.0),
        ]
    specs += [
        ("batch_norm.weight", (d,), "ones", 0.0),
        ("batch_norm.bias", (d,), "zeros", 0.0),
        ("out.weight", (c, d), "normal", math.sqrt(1.0 / d)),
        ("out.bias", (c,), "zeros", 0.0),
    ]
    return specs


def adjacency(senders: np.ndarray, receivers: np.ndarray, n_valid: int) -> Tuple[np.ndarray, ...]:
    """(rows, cols, vals) of D^-1 (B + I) over ``n_valid`` windows: each
    distinct contact once per direction, a self-loop per window, every
    entry of a row equal to one over its count."""
    keys = np.unique(np.concatenate([
        receivers.astype(np.int64) * n_valid + senders,
        np.arange(n_valid, dtype=np.int64) * (n_valid + 1)]))
    rows, cols = keys // n_valid, keys % n_valid
    degree = np.bincount(rows, minlength=n_valid)
    return rows, cols, 1.0 / degree[rows]


class Graph:
    """The adjacency on a device, in the reference's type."""

    def __init__(self, adj, n_valid: int, dtype, device):
        rows, cols, vals = adj
        self.n = n_valid
        self.rows = torch.as_tensor(rows, device=device)
        self.cols = torch.as_tensor(cols, device=device)
        self.vals = torch.as_tensor(vals, dtype=dtype, device=device)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        out = x.new_zeros((self.n, x.shape[1]))
        return out.index_add_(0, self.rows, x[self.cols] * self.vals[:, None])


def _dropout(x: torch.Tensor, p: float, n_pad: int, gen: torch.Generator) -> torch.Tensor:
    if p == 0.0:
        return x
    keep = torch.empty((n_pad, x.shape[1]), dtype=torch.float32,
                       device=x.device).bernoulli_(1.0 - p, generator=gen)
    return torch.where(keep[: x.shape[0]].bool(), x / (1.0 - p), torch.zeros_like(x))


class BatchNormStats:
    """Running BatchNorm statistics (momentum, unbiased variance), for the
    eval passes."""

    def __init__(self, d: int, momentum: float, dtype, device, start=None):
        self.momentum = momentum
        self.mean = torch.zeros(d, dtype=dtype, device=device)
        self.var = torch.ones(d, dtype=dtype, device=device)
        if start is not None:
            self.mean, self.var = (torch.as_tensor(s, dtype=dtype, device=device) for s in start)

    def update(self, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
        m = self.momentum
        self.mean = (1 - m) * self.mean + m * mean.detach()
        self.var = (1 - m) * self.var + m * var.detach() * n / (n - 1)


def gated(cfg: dict, w: Dict[str, torch.Tensor], x: torch.Tensor, graph: Graph,
          between=lambda v: v) -> torch.Tensor:
    """The gated residual layers, ``between`` applied between two."""
    for layer in range(1, cfg["layers"] + 1):
        z = torch.tanh(graph @ (x @ w[f"GC{layer}.weight"]) + w[f"GC{layer}.bias"])
        g = torch.sigmoid(z @ w[f"W{layer}.weight"].t() + w[f"W{layer}.bias"])
        x = (1.0 - g) * x + g * z
        if layer < cfg["layers"]:
            x = between(x)
    return x


def feature_stats(cfg: dict, w: Dict[str, torch.Tensor], data: Dict[str, torch.Tensor],
                  graph: Graph) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and unbiased variance per feature of ReLU(gated layers) over
    both strands' rows, without dropout: what a trained head's BatchNorm
    holds as its running statistics."""
    with torch.no_grad():
        h = torch.cat([torch.relu(gated(cfg, w, data[k], graph)) for k in ("x_f", "x_r")])
    return h.mean(0), h.var(0)


def strand_features(cfg: dict, w: Dict[str, torch.Tensor], x: torch.Tensor, graph: Graph,
                    n_pad: int, gen: Optional[torch.Generator],
                    stats: Optional[BatchNormStats], train: bool) -> torch.Tensor:
    """One strand's penultimate features: the gated layers, ReLU, BatchNorm
    (batch statistics when training, which update ``stats``; else
    ``stats``), dropout when training."""
    p = cfg["dropout"] if train else 0.0
    h = torch.relu(gated(cfg, w, x, graph, lambda v: _dropout(v, p, n_pad, gen)))
    if train:
        mean = h.mean(0)
        var = (h - mean).square().mean(0)
        stats.update(mean, var, h.shape[0])
    else:
        mean, var = stats.mean, stats.var
    h = (h - mean) * torch.rsqrt(var + cfg["batch_norm"]["eps"])
    h = h * w["batch_norm.weight"] + w["batch_norm.bias"]
    return _dropout(h, p, n_pad, gen)


def bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, targets, reduction="mean")


def head_logits(cfg: dict, w, data: Dict[str, torch.Tensor], graph: Graph, n_pad: int,
                gen: Optional[torch.Generator], stats: BatchNormStats,
                train: bool) -> torch.Tensor:
    """The chromosome's logits: both strands, the head over their mean."""
    h_f = strand_features(cfg, w, data["x_f"], graph, n_pad, gen, stats, train)
    h_r = strand_features(cfg, w, data["x_r"], graph, n_pad, gen, stats, train)
    return ((h_f + h_r) / 2.0) @ w["out.weight"].t() + w["out.bias"]


def step_loss(cfg: dict, w, data: Dict[str, torch.Tensor], graph: Graph, n_pad: int,
              gen: Optional[torch.Generator], stats: BatchNormStats, train: bool,
              half_batch: bool = False) -> torch.Tensor:
    """The chromosome's loss. ``half_batch`` takes the mean over the first
    half of the rows only (a planted fault)."""
    logits = head_logits(cfg, w, data, graph, n_pad, gen, stats, train)
    if half_batch:
        half = logits.shape[0] // 2
        return bce(logits[:half], data["targets"][:half])
    return bce(logits, data["targets"])


def loss_fn(cfg: dict, sets: List[Dict[str, torch.Tensor]], graph: Graph, n_pad: int,
            dropout_seed: int, dtype, device, half_batch: bool = False, stats_start=None):
    """``loss(w, i)``: step i's training loss on ``sets[i % len(sets)]``
    (each the valid rows of ``x_f``, ``x_r``, ``targets``), cast to
    ``dtype``, with the dropout generator and BatchNorm statistics
    (``loss.stats``, which an eval pass reads; from ``stats_start``, a mean
    and a variance, where given) carried from step to step."""
    gen = torch.Generator(device=device).manual_seed(dropout_seed)
    stats = BatchNormStats(cfg["nhid"], cfg["batch_norm"]["momentum"], dtype, device,
                           stats_start)
    cast = [{k: v.to(dtype) for k, v in s.items()} for s in sets]

    def loss(w, i):
        return step_loss(cfg, w, cast[i % len(cast)], graph, n_pad, gen, stats, True,
                         half_batch)

    loss.stats = stats
    return loss
