"""Gated GCN chromosome model (port of chromegcn_tpu/models/chrome.py).

All window feature vectors of one chromosome (N x d) are refined jointly
over the Hi-C adjacency, then re-classified
(reference: models/ChromeModels.py:34-52):

    z_l   = tanh(GC_l(x, A))            GC: A (X W) + b   [SpMM]
    g_l   = sigmoid(W_l z_l)            per-node scalar gate
    x     = (1 - g_l) * x + g_l * z_l   gated residual update
    out   = Linear(Dropout(BatchNorm(ReLU(x))))

Parameter names are the reference torch model's (utils/parity.py:38-47):
``GC1.weight`` stored (in, out), ``W1``, ``GC2``, ``W2``, ``batch_norm``,
``out``. The forward always gates; ``gate`` is kept for config parity.

``fused="on"`` runs each layer through ``ops.gcn_fused.fused_gated_layer``
(kernels B2 and B3) when the graph carries a BSR operator and the kernels
take the width (reference: models/chrome.py:151-217). The parameters are the
same ones, so a state_dict carries over between the two paths.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from chromegcn_tpu_torch.models.norm import MaskedBatchNorm
from chromegcn_tpu_torch.ops.gcn_fused import fused_fits, fused_gated_layer
from chromegcn_tpu_torch.ops.sparse import SparseGraph
from chromegcn_tpu_torch.ops.spmm import spmm
from chromegcn_tpu_torch.ops.spmm_bsr import BSROperator


def _dropout(
    x: torch.Tensor, p: float, train: bool, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """Inverted dropout drawing its mask from ``generator`` (flax semantics:
    keep with probability 1-p, scale kept values by 1/(1-p))."""
    if not train or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return torch.where(keep.bool(), x / (1.0 - p), torch.zeros_like(x))


def _lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """flax's lecun_normal for a torch (out, in) Linear or (out, in, k) Conv1d
    weight: truncated normal on [-2, 2] std units, std sqrt(1/fan_in)
    (fan_in = in k) corrected for truncation."""
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


class GraphConvolution(nn.Module):
    """A (X W) + b (reference: models/SubLayers.py:7-57); weight (in, out),
    xavier-normal init with gain 0.02 (reference: models/SubLayers.py:33)."""

    def __init__(self, in_features: int, out_features: int, spmm_impl: str = "auto"):
        super().__init__()
        self.spmm_impl = spmm_impl
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        fan_in, fan_out = self.weight.shape
        std = 0.02 * math.sqrt(2.0 / (fan_in + fan_out))
        nn.init.normal_(self.weight, std=std, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, graph: Optional[SparseGraph]) -> torch.Tensor:
        support = x @ self.weight
        if graph is None:
            out = support
        elif support.dim() == 3:
            # (N, S, d) strand-stacked input: SpMM is linear over the feature
            # axis, so the strands share one aggregation pass
            n, s, d = support.shape
            out = spmm(graph, support.reshape(n, s * d), impl=self.spmm_impl)
            out = out.reshape(n, s, d)
        else:
            out = spmm(graph, support, impl=self.spmm_impl)
        return out + self.bias


class ChromeGCN(nn.Module):
    """Gated residual 1- or 2-layer GCN head (reference:
    models/ChromeModels.py:21-52). Accepts (N, d) or strand-stacked (N, S, d)
    input; with stacking, BatchNorm statistics pool both strands."""

    def __init__(
        self,
        nfeat: int = 128,
        nhid: int = 128,
        nclass: int = 919,
        dropout: float = 0.2,
        gate: bool = True,
        layers: int = 2,
        spmm_impl: str = "auto",
        fused: str = "off",
    ):
        super().__init__()
        if fused not in ("off", "on"):
            raise ValueError(f"fused must be 'off' or 'on', got {fused!r}")
        if layers not in (1, 2):
            raise ValueError(f"layers must be 1 or 2, got {layers}")
        self.nfeat, self.nhid = nfeat, nhid
        self.spmm_impl = spmm_impl
        self.fused = fused
        self.dropout = dropout
        self.gate = gate
        self.layers = layers
        self.GC1 = GraphConvolution(nfeat, nhid, spmm_impl)
        self.W1 = nn.Linear(nhid, 1)
        if layers == 2:
            self.GC2 = GraphConvolution(nhid, nfeat, spmm_impl)
            self.W2 = nn.Linear(nfeat, 1)
        self.batch_norm = MaskedBatchNorm(nfeat)
        self.out = nn.Linear(nfeat, nclass)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The reference's initializers: GC xavier gain 0.02, Linear
        lecun-normal (flax Dense), zero biases, BatchNorm identity."""
        for name in ("GC1", "GC2"):
            if hasattr(self, name):
                getattr(self, name).reset_parameters(generator)
        for name in ("W1", "W2", "out"):
            if hasattr(self, name):
                lin = getattr(self, name)
                _lecun_normal_(lin.weight.data, generator)
                nn.init.zeros_(lin.bias)
        bn = self.batch_norm
        nn.init.ones_(bn.weight)
        nn.init.zeros_(bn.bias)
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0)

    def _use_fused(self, x: torch.Tensor, graph: Optional[SparseGraph]) -> bool:
        """The reference's conditions (models/chrome.py:151-163), with the
        kernels' own ``fused_fits`` in place of the TPU's VMEM budget."""
        return (
            self.fused == "on"
            and self.spmm_impl in ("auto", "pallas")
            and graph is not None
            and isinstance(graph.bsr, BSROperator)
            and x.dim() == 2
            and x.shape[-1] == self.nhid == self.nfeat
            and fused_fits(graph.bsr, x.shape[-1])
        )

    @staticmethod
    def _gated_layer(gc: GraphConvolution, gate: nn.Linear, x: torch.Tensor,
                     graph: Optional[SparseGraph], use_fused: bool):
        """One gated residual layer; returns (x_next, g)."""
        if use_fused:
            x, _, g = fused_gated_layer(graph.bsr, x, gc.weight, gc.bias,
                                        gate.weight.t(), gate.bias)
            return x, g
        z = torch.tanh(gc(x, graph))
        g = torch.sigmoid(gate(z))
        return (1.0 - g) * x + g * z, g

    def forward(
        self,
        x_in: torch.Tensor,
        graph: Optional[SparseGraph],
        train: bool,
        node_mask: Optional[torch.Tensor] = None,
        skip_head: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, Optional[torch.Tensor]]]:
        """Returns (x_refined, logits, (gate1, gate2)).

        ``train`` selects batch statistics (updating the running ones) and
        dropout, whose masks come from ``generator``. ``skip_head=True``
        returns the post-dropout penultimate features in place of logits:
        the head is linear, so the steps apply it once to strand-averaged
        features."""
        if node_mask is None and graph is not None:
            node_mask = graph.node_mask
        use_fused = self._use_fused(x_in, graph)
        x, g = self._gated_layer(self.GC1, self.W1, x_in, graph, use_fused)

        g2 = None
        if self.layers == 2:
            x = _dropout(x, self.dropout, train, generator)
            x, g2 = self._gated_layer(self.GC2, self.W2, x, graph, use_fused)

        h = torch.relu(x)
        h = self.batch_norm(h, use_running_average=not train, mask=node_mask)
        h = _dropout(h, self.dropout, train, generator)
        if skip_head:
            return x, h, (g, g2)
        return x, self.out(h), (g, g2)


def make_chrome_model(
    name: str,
    nclass: int,
    dropout: float = 0.2,
    gate: bool = True,
    layers: int = 2,
    nfeat: int = 128,
    spmm_impl: str = "auto",
    fused: str = "off",
) -> nn.Module:
    """Factory mirroring the reference dispatch (reference: main.py:59-62)."""
    name = name.lower()
    if name == "gcn":
        return ChromeGCN(
            nfeat=nfeat, nhid=nfeat, nclass=nclass, dropout=dropout,
            gate=gate, layers=layers, spmm_impl=spmm_impl, fused=fused,
        )
    if name == "rnn":
        raise NotImplementedError(
            "ChromeRNN is not ported yet: ROADMAP item A12"
        )
    raise ValueError(f"unknown chrome model {name!r}")
