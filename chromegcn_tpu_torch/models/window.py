"""Window (sequence) models: Expecto, DeepSEA, DanQ (port of
chromegcn_tpu/models/window.py).

Per-window DNA tokens (B, L) -> (feature vector, multi-label logits). The
port keeps PyTorch's channels-first layout: embedding (B, L, 5) -> (B, 5, L)
-> Conv1d / MaxPool1d (floor) / BatchNorm1d. The flatten before the first
Linear is therefore channel-major (C L), where the JAX models flatten
length-major (L C); ``utils/convert.py`` permutes that Linear's weight.

What is kept from the reference (models/WindowModels.py:9-204):
- the dropout rates are the architecture's (0.2 and 0.5), not ``-dropout``;
- DeepSEA's classifier reads the pre-ReLU feature vector;
- DanQ's feature is its 925-wide ReLU'd first Linear output, and its
  post-pool length is derived from ``seq_length`` (151 at 2,000);
- flax's initial distributions: lecun-normal kernels and zero biases, the
  embedding's variance-scaling normal (std sqrt(1/5)), and for the LSTM
  lecun-normal input kernels, orthogonal recurrent kernels per gate and
  zero biases.

A plain ``nn.BatchNorm1d`` has the reference's semantics here (the JAX
package's MaskedBatchNorm with no mask): biased variance to normalise,
unbiased into ``running_var``, momentum 0.1, eps 1e-5. The window model gets
no row mask, so a tail batch's padding rows enter the statistics, as they
do in the JAX package.

These layers are convolutions, an LSTM and dense products, which the JAX
package leaves to XLA outside any Pallas kernel: here they are PyTorch's
(cuBLAS's GEMMs; cuDNN's in the fast mode only, train/pretrain.py says
why). Dropout masks come from the ``generator`` passed to ``forward``;
DanQ's LSTM draws its inter-layer dropout from torch's default generator of
the device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from chromegcn_tpu_torch.models.chrome import _dropout, _lecun_normal_


class Dropout(nn.Dropout):
    """``nn.Dropout`` whose mask comes from ``generator`` when one is given
    (inverted dropout: keep with probability 1-p, scale by 1/(1-p), as flax)."""

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        if generator is None:
            return F.dropout(x, self.p, self.training)
        return _dropout(x, self.p, self.training, generator)


def _reset_window_model(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """flax's initializers for every layer of a window model."""
    for m in model.modules():
        if isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, std=math.sqrt(1.0 / m.weight.shape[1]),
                            generator=generator)
        elif isinstance(m, (nn.Conv1d, nn.Linear)):
            _lecun_normal_(m.weight.data, generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm1d):
            m.reset_parameters()
        elif isinstance(m, nn.LSTM):
            h = m.hidden_size
            for name, p in m.named_parameters():
                if name.startswith("bias"):
                    nn.init.zeros_(p)
                    continue
                # one (H, in) block per gate i, f, g, o, as flax's per-gate Dense
                for k in range(4):
                    block = p.data[k * h:(k + 1) * h]
                    if name.startswith("weight_ih"):
                        _lecun_normal_(block, generator)
                    else:
                        nn.init.orthogonal_(block, generator=generator)


class Expecto(nn.Module):
    """ExPecto-style CNN (Zhou et al. 2018): 6 valid convolutions (k 8) in 3
    blocks of 320/480/960 channels, two 4x max pools, BatchNorm per block,
    dropout 0.2/0.5, a Linear to the d_model feature, and a classifier over
    the ReLU'd, BatchNorm'd features (reference: window.py:36-83)."""

    def __init__(self, n_targets: int, seq_length: int = 2000, d_model: int = 128):
        super().__init__()
        self.seq_length = seq_length
        self.embed = nn.Embedding(5, 5)
        self.conv1a, self.conv1b = nn.Conv1d(5, 320, 8), nn.Conv1d(320, 320, 8)
        self.bn1 = nn.BatchNorm1d(320)
        self.conv2a, self.conv2b = nn.Conv1d(320, 480, 8), nn.Conv1d(480, 480, 8)
        self.bn2 = nn.BatchNorm1d(480)
        self.drop2 = Dropout(0.2)
        self.conv3a, self.conv3b = nn.Conv1d(480, 960, 8), nn.Conv1d(960, 960, 8)
        self.bn3 = nn.BatchNorm1d(960)
        self.drop3 = Dropout(0.5)
        self.linear = nn.Linear(960 * self.n_channels, d_model)
        self.head_bn = nn.BatchNorm1d(d_model)
        self.classifier = nn.Linear(d_model, n_targets)
        self.reset_parameters()

    @property
    def n_channels(self) -> int:
        """Length of the last conv's output (reference: window.py:48-53)."""
        reduce_by = 2 * (8 - 1)
        n = (self.seq_length - reduce_by) // 4
        n = (n - reduce_by) // 4
        return n - reduce_by

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _reset_window_model(self, generator)

    def forward(self, tokens: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.embed(tokens.long()).transpose(1, 2)  # (B, 5, L)
        x = F.relu(self.conv1a(x))
        x = F.relu(self.conv1b(x))
        x = self.bn1(F.max_pool1d(x, 4))
        x = F.relu(self.conv2a(x))
        x = F.relu(self.conv2b(x))
        x = self.drop2(self.bn2(F.max_pool1d(x, 4)), generator)
        x = F.relu(self.conv3a(x))
        x = F.relu(self.conv3b(x))
        x = self.drop3(self.bn3(x), generator)
        x_feat = self.linear(x.flatten(1))
        logits = self.classifier(self.head_bn(F.relu(x_feat)))
        return x_feat, logits


class DeepSEA(nn.Module):
    """DeepSEA CNN (Zhou & Troyanskaya 2015); the classifier reads the
    pre-ReLU feature vector, as the reference's does (reference:
    window.py:86-120)."""

    def __init__(self, n_targets: int, seq_length: int = 2000, d_model: int = 128):
        super().__init__()
        self.seq_length = seq_length
        self.embed = nn.Embedding(5, 5)
        self.conv1 = nn.Conv1d(5, 320, 8)
        self.drop1 = Dropout(0.2)
        self.conv2 = nn.Conv1d(320, 480, 8)
        self.drop2 = Dropout(0.2)
        self.conv3 = nn.Conv1d(480, 960, 8)
        self.drop3 = Dropout(0.5)
        self.linear = nn.Linear(960 * self.n_channels, d_model)
        self.classifier = nn.Linear(d_model, n_targets)
        self.reset_parameters()

    @property
    def n_channels(self) -> int:
        """Length of the last conv's output (reference: window.py:98-103)."""
        reduce_by = 8 - 1
        n = (self.seq_length - reduce_by) // 4
        n = (n - reduce_by) // 4
        return n - reduce_by

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _reset_window_model(self, generator)

    def forward(self, tokens: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.embed(tokens.long()).transpose(1, 2)
        x = self.drop1(F.max_pool1d(F.relu(self.conv1(x)), 4), generator)
        x = self.drop2(F.max_pool1d(F.relu(self.conv2(x)), 4), generator)
        x = self.drop3(F.relu(self.conv3(x)), generator)
        x_feat = self.linear(x.flatten(1))
        return x_feat, self.classifier(x_feat)


class DanQ(nn.Module):
    """DanQ CNN + BiLSTM (Quang & Xie 2015): conv (k 26), 13x max pool, a
    batch-first bidirectional 2-layer LSTM with inter-layer dropout 0.5, and
    the 925-wide ReLU'd feature (reference: window.py:123-174)."""

    def __init__(self, n_targets: int, seq_length: int = 2000):
        super().__init__()
        self.seq_length = seq_length
        self.embed = nn.Embedding(5, 5)
        self.conv1 = nn.Conv1d(5, 320, 26)
        self.drop1 = Dropout(0.2)
        self.bilstm = nn.LSTM(320, 320, num_layers=2, batch_first=True, dropout=0.5,
                              bidirectional=True)
        self.linear1 = nn.Linear(640 * self.n_steps, 925)
        self.linear2 = nn.Linear(925, n_targets)
        self.reset_parameters()

    @property
    def n_steps(self) -> int:
        """LSTM steps after the pool (reference: window.py:159-161)."""
        return (self.seq_length - 25) // 13

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _reset_window_model(self, generator)

    def forward(self, tokens: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.embed(tokens.long()).transpose(1, 2)
        x = self.drop1(F.max_pool1d(F.relu(self.conv1(x)), 13), generator)
        x, _ = self.bilstm(x.transpose(1, 2).contiguous())  # (B, T, 640), both directions
        x_feat = F.relu(self.linear1(x.flatten(1)))
        return x_feat, self.linear2(x_feat)


WINDOW_MODELS = {"expecto": Expecto, "deepsea": DeepSEA, "danq": DanQ}


def make_window_model(name: str, n_targets: int, seq_length: int = 2000,
                      d_model: int = 128) -> nn.Module:
    """Factory mirroring the reference dispatch (reference: main.py:40-45)."""
    name = name.lower()
    if name == "danq":
        return DanQ(n_targets=n_targets, seq_length=seq_length)
    if name in WINDOW_MODELS:
        return WINDOW_MODELS[name](n_targets=n_targets, seq_length=seq_length, d_model=d_model)
    raise ValueError(f"unknown window model {name!r}")
