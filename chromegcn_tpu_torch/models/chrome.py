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

``ChromeRNN`` (``-chrome_model rnn``) reads the chromosome's windows as one
sequence through bidirectional LSTMs instead (reference:
models/ChromeModels.py:55-72). Its LSTMs, and DanQ's, run through
``lstm_forward``, which puts them on cuDNN on the card: the f32 parity mode
turns cuDNN off for the whole process because cuDNN's f32 backward
convolutions are not f32-faithful (train/pretrain.py), but cuDNN's RNN is
(DanQ's LSTM within 2.4e-6 of scale of float64 on the H100), and without
cuDNN an LSTM runs PyTorch's cell kernels, a few launches per time step.
TF32 stays as the process has it: off in the parity mode, on in the fast
mode. Convolutions stay off cuDNN.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Tuple

import torch
from torch import nn

from chromegcn_tpu_torch.models.norm import MaskedBatchNorm
from chromegcn_tpu_torch.ops.gcn_fused import fused_fits, fused_gated_layer
from chromegcn_tpu_torch.ops.sparse import SparseGraph
from chromegcn_tpu_torch.ops.spmm import spmm
from chromegcn_tpu_torch.ops.spmm_bsr import BSROperator
from chromegcn_tpu_torch.parallel.mesh import all_gather_rows, group_rank
from chromegcn_tpu_torch.utils import profiling

# the longest sequence cuDNN's RNN takes on the H100 (cuDNN 9 with torch
# 2.11; longer ones fail with CUDNN_STATUS_NOT_SUPPORTED): ``lstm_forward``
# runs a longer one in segments
CUDNN_MAX_STEPS = 65_535

# ``lstm_forward`` calls (sweeps: an LSTM module, every layer and direction
# of it, over a whole batch of sequences) and the positions they read
# (length x batch) in this process; the ``train_step`` spans record their
# growth (``profiling.span``'s counters)
LSTM_COUNTS = {"lstm_sweeps": 0, "lstm_positions": 0}


def _dropout(
    x: torch.Tensor, p: float, train: bool, generator: Optional[torch.Generator],
    group=None,
) -> torch.Tensor:
    """Inverted dropout drawing its mask from ``generator`` (flax semantics:
    keep with probability 1-p, scale kept values by 1/(1-p)).

    ``x`` row-sharded over ``group``: every rank draws the whole mask from
    its generator, which all ranks seed alike, and keeps its rows. So the
    ranks drop as one device would from the same generator, and leave it in
    the same state."""
    if not train or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    if group is None:
        keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    else:
        rank, world = group_rank(group)
        n = x.shape[0]
        keep = x.new_empty((world * n,) + x.shape[1:]).bernoulli_(1.0 - p, generator=generator)
        keep = keep[rank * n:(rank + 1) * n]
    return torch.where(keep.bool(), x / (1.0 - p), torch.zeros_like(x))


def _lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """flax's lecun_normal for a torch (out, in) Linear or (out, in, k) Conv1d
    weight: truncated normal on [-2, 2] std units, std sqrt(1/fan_in)
    (fan_in = in k) corrected for truncation."""
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def init_lstm_(lstm: nn.LSTM, generator: Optional[torch.Generator]) -> None:
    """flax's OptimizedLSTMCell initializers, per gate i, f, g, o:
    lecun-normal input kernels, orthogonal recurrent kernels, zero biases.

    flax's cell has one bias per gate, torch's two (``bias_ih`` and
    ``bias_hh``), whose gradients are equal: trained both, they would move
    the gate's bias twice as far as flax's per step. So ``bias_hh`` stays
    zero and out of training, and ``bias_ih`` is flax's bias."""
    h = lstm.hidden_size
    for name, p in lstm.named_parameters():
        if name.startswith("bias"):
            nn.init.zeros_(p)
            if name.startswith("bias_hh"):
                p.requires_grad_(False)
            continue
        for k in range(4):
            block = p.data[k * h:(k + 1) * h]
            if name.startswith("weight_ih"):
                _lecun_normal_(block, generator)
            else:
                nn.init.orthogonal_(block, generator=generator)


def _is_flat(lstm: nn.LSTM) -> bool:
    """Whether the LSTM's weights sit in one buffer, as cuDNN reads them."""
    return len({p.untyped_storage().data_ptr() for p in lstm.parameters()}) == 1


def lstm_segments(lstm: nn.LSTM, x: torch.Tensor, most: int) -> torch.Tensor:
    """``lstm(x)[0]`` for a single-layer, batch-first LSTM, each direction
    run over consecutive segments of at most ``most`` positions (the reverse
    direction over the flipped sequence), its (h, c) carried from segment to
    segment: the same recurrence, in calls no longer than ``most``. On the
    H100 two one-direction calls take as long as one bidirectional call
    (117.8 and 119.2 ms forward and backward at 49,152 positions), so the
    directions run one after the other."""
    if lstm.num_layers != 1 or not lstm.batch_first or lstm.proj_size:
        raise ValueError("lstm_segments runs single-layer, batch-first LSTMs")
    batch, length = x.shape[:2]
    n = -(-length // most)
    bounds = [length * k // n for k in range(n + 1)]
    zeros = x.new_zeros((1, batch, lstm.hidden_size))
    outs = []
    with warnings.catch_warnings():
        # a direction's weights are views of the module's one buffer, which
        # cuDNN copies into its layout at each call (a few hundred kB)
        warnings.filterwarnings("ignore", message="RNN module weights are not part")
        for d, names in enumerate(lstm._all_weights):
            params = [getattr(lstm, name) for name in names]
            seq, state, parts = (x.flip(1) if d else x), (zeros, zeros), []
            for a, b in zip(bounds, bounds[1:]):
                out, h, c = torch.lstm(seq[:, a:b].contiguous(), state, params, lstm.bias, 1,
                                       0.0, lstm.training, False, True)
                parts.append(out)
                state = (h, c)
            y = torch.cat(parts, 1)
            outs.append(y.flip(1) if d else y)
    return torch.cat(outs, -1)


def lstm_forward(lstm: nn.LSTM, x: torch.Tensor) -> torch.Tensor:
    """``lstm(x)``'s output sequence.

    On the card the call runs through cuDNN's RNN whatever the process-wide
    cuDNN switch says, forward and backward (the backward reads what the
    forward saved), with TF32 as the process has it. cuDNN's backward needs
    its training-mode forward, so when autograd records an LSTM in eval
    mode, the call runs in training mode with the inter-layer dropout off:
    the outputs are eval mode's. A sequence longer than cuDNN takes
    (``CUDNN_MAX_STEPS``) runs in segments (``lstm_segments``).

    Each call is a span ``lstm`` (attributes ``positions``, the sequence
    length, ``batch`` and ``directions``) and counts one sweep in
    ``LSTM_COUNTS``."""
    batch, length = x.shape[:2]  # every LSTM of the port is batch-first
    LSTM_COUNTS["lstm_sweeps"] += 1
    LSTM_COUNTS["lstm_positions"] += length * batch
    with profiling.span("lstm", positions=length, batch=batch,
                        directions=2 if lstm.bidirectional else 1):
        if x.device.type != "cuda":
            return lstm(x)[0]
        cudnn = torch.backends.cudnn
        saved = (cudnn.enabled, lstm.training, lstm.dropout)
        try:
            cudnn.enabled = True
            if not _is_flat(lstm):
                lstm.flatten_parameters()
            if not lstm.training and torch.is_grad_enabled():
                lstm.training, lstm.dropout = True, 0.0
            if length > CUDNN_MAX_STEPS:
                return lstm_segments(lstm, x, CUDNN_MAX_STEPS)
            return lstm(x)[0]
        finally:
            cudnn.enabled = saved[0]
            lstm.training, lstm.dropout = saved[1], saved[2]


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
        self.batch_norm.reset_parameters()

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
        group = getattr(graph, "group", None)
        use_fused = self._use_fused(x_in, graph)
        x, g = self._gated_layer(self.GC1, self.W1, x_in, graph, use_fused)

        g2 = None
        if self.layers == 2:
            x = _dropout(x, self.dropout, train, generator, group)
            x, g2 = self._gated_layer(self.GC2, self.W2, x, graph, use_fused)

        h = torch.relu(x)
        h = self.batch_norm(h, use_running_average=not train, mask=node_mask, group=group)
        h = _dropout(h, self.dropout, train, generator, group)
        if skip_head:
            return x, h, (g, g2)
        return x, self.out(h), (g, g2)


class ChromeRNN(nn.Module):
    """BiLSTM over the window sequence of a chromosome (reference:
    models/chrome.py:230-272; models/ChromeModels.py:55-72).

    The chromosome's N_pad rows are one sequence, batch 1, through ``layers``
    bidirectional LSTM layers of hidden ``nfeat // 2``, with dropout (from
    ``generator``) between layers; then ReLU, the masked BatchNorm, dropout
    and the head. Each layer is its own single-layer ``nn.LSTM``, so the
    dropout between layers is the port's ``_dropout``, not the one
    ``nn.LSTM(num_layers=...)`` draws from torch's global generator.

    The padded suffix is part of the sequence, as in the reference: the
    reverse direction reads it before the last valid window, so each valid
    output depends on the node bucket. ``graph`` is read only for its
    ``node_mask`` and, on a graph row-sharded over a process group, its
    ``group``: then each rank gathers the whole sequence, runs it, and keeps
    its rows (the ranks' generators agree, so that their dropout masks do).
    Returns (x_in, logits or features, (None, None))."""

    def __init__(self, nfeat: int = 128, nclass: int = 919, dropout: float = 0.2,
                 layers: int = 2):
        super().__init__()
        hidden = nfeat // 2
        self.dropout = dropout
        self.rnn = nn.ModuleList(
            nn.LSTM(nfeat if i == 0 else 2 * hidden, hidden, batch_first=True,
                    bidirectional=True)
            for i in range(layers))
        self.batch_norm = MaskedBatchNorm(2 * hidden)
        self.out = nn.Linear(2 * hidden, nclass)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initializers: the LSTM cells', a lecun-normal head with a
        zero bias, BatchNorm identity."""
        for lstm in self.rnn:
            init_lstm_(lstm, generator)
        _lecun_normal_(self.out.weight.data, generator)
        nn.init.zeros_(self.out.bias)
        self.batch_norm.reset_parameters()

    def forward(
        self,
        x_in: torch.Tensor,
        graph: Optional[SparseGraph],
        train: bool,
        node_mask: Optional[torch.Tensor] = None,
        skip_head: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[None, None]]:
        if node_mask is None and graph is not None:
            node_mask = graph.node_mask
        group = getattr(graph, "group", None)
        # row-sharded over a process group: every rank runs the whole
        # sequence and keeps its own rows
        x = x_in if group is None else all_gather_rows(x_in, group)
        x = x[None]  # (1, N, d): the chromosome as one sequence
        for i, lstm in enumerate(self.rnn):
            x = lstm_forward(lstm, x)
            if i + 1 < len(self.rnn):
                x = _dropout(x, self.dropout, train, generator)
        h = torch.relu(x[0])
        if group is not None:
            rank, _ = group_rank(group)
            h = h[rank * x_in.shape[0]:(rank + 1) * x_in.shape[0]]
        h = self.batch_norm(h, use_running_average=not train, mask=node_mask, group=group)
        h = _dropout(h, self.dropout, train, generator, group)
        if skip_head:
            return x_in, h, (None, None)
        return x_in, self.out(h), (None, None)


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
        return ChromeRNN(nfeat=nfeat, nclass=nclass, dropout=dropout, layers=layers)
    raise ValueError(f"unknown chrome model {name!r}")
