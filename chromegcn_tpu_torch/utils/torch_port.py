"""Bring the original PyTorch ChromeGCN's checkpoints into the port's
modules (the counterpart of chromegcn_tpu/utils/torch_port.py, which maps
them onto flax).

The port's models are channels-first torch modules like the original's, so
most weights keep their layout and change only their names:

- convolutions (out, in, k) and Linears (out, in) as they are; the first
  Linear after the flatten too, since both flatten channel-major;
- the original's ``src_word_emb`` is ``embed``, its Sequential indices
  (``conv_net.0`` ...) are named layers, its head BatchNorm is ``head_bn``;
- an LSTM direction's two biases sum into ``bias_ih``, and ``bias_hh`` is
  zero: the port trains one bias per gate, as flax's cell has
  (models/chrome.py:init_lstm_);
- ChromeRNN's one multi-layer ``lstm`` becomes one single-layer LSTM per
  layer (``rnn.{l}``);
- the chromosome models' BatchNorm is the port's masked one, which keeps
  no ``num_batches_tracked``.

Each function returns a ``state_dict`` for the bare model (``Expecto``,
``DeepSEA``, ``DanQ``, ``ChromeGCN``, ``ChromeRNN``); a window model's
NonStrandSpecific wrapper takes the same keys under ``model.``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a)).clone()


def _copy(state: Mapping, names: Mapping[str, str]) -> Dict[str, torch.Tensor]:
    """{ours + suffix: state[theirs + suffix]} for every key of ``state``
    under each ``theirs.`` prefix."""
    out = {}
    for ours, theirs in names.items():
        for key, value in state.items():
            if key.startswith(theirs + "."):
                out[ours + key[len(theirs):]] = _t(value)
    return out


def _lstm(state: Mapping, prefix: str, layer: int, suffix: str, to: str) -> Dict[str, torch.Tensor]:
    """One direction of one layer of a torch LSTM, its biases summed into
    ``bias_ih`` and ``bias_hh`` zero, under the names ``to``."""
    def g(name):
        return np.asarray(state[f"{prefix}.{name}_l{layer}{suffix}"])

    bias = g("bias_ih") + g("bias_hh")
    return {
        to.format("weight_ih"): _t(g("weight_ih")),
        to.format("weight_hh"): _t(g("weight_hh")),
        to.format("bias_ih"): _t(bias),
        to.format("bias_hh"): _t(np.zeros_like(bias)),
    }


def port_expecto(state: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The original Expecto (reference models/WindowModels.py:9-87: conv_net
    indices 0, 2, 5, 6, 8, 11, 13, 15, 17; linear; batch_norm; classifier)."""
    return _copy(state, {
        "embed": "src_word_emb",
        "conv1a": "conv_net.0", "conv1b": "conv_net.2", "bn1": "conv_net.5",
        "conv2a": "conv_net.6", "conv2b": "conv_net.8", "bn2": "conv_net.11",
        "conv3a": "conv_net.13", "conv3b": "conv_net.15", "bn3": "conv_net.17",
        "linear": "linear", "head_bn": "batch_norm", "classifier": "classifier",
    })


def port_deepsea(state: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The original DeepSEA (reference models/WindowModels.py:89-156:
    conv_net indices 0, 4, 8; linear; classifier)."""
    return _copy(state, {
        "embed": "src_word_emb", "conv1": "conv_net.0", "conv2": "conv_net.4",
        "conv3": "conv_net.8", "linear": "linear", "classifier": "classifier",
    })


def port_danq(state: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The original DanQ (reference models/WindowModels.py:158-204: Conv1,
    a 2-layer bidirectional BiLSTM, Linear1, Linear2)."""
    out = _copy(state, {"embed": "src_word_emb", "conv1": "Conv1",
                        "linear1": "Linear1", "linear2": "Linear2"})
    for layer in range(2):
        for suffix in ("", "_reverse"):
            out.update(_lstm(state, "BiLSTM", layer, suffix,
                             f"bilstm.{{}}_l{layer}{suffix}"))
    return out


def port_chromegcn(state: Mapping[str, np.ndarray], layers: int = 2) -> Dict[str, torch.Tensor]:
    """The original ChromeGCN (reference models/ChromeModels.py:21-52): the
    same names; GraphConvolution stores its weight (in, out) in both."""
    names = ["GC1", "W1", "batch_norm", "out"] + (["GC2", "W2"] if layers == 2 else [])
    out = _copy(state, {n: n for n in names})
    out.pop("batch_norm.num_batches_tracked", None)
    return out


def port_chromernn(state: Mapping[str, np.ndarray], layers: int = 2) -> Dict[str, torch.Tensor]:
    """The original ChromeRNN (reference models/ChromeModels.py:55-72: one
    bidirectional ``lstm`` of ``layers`` layers, batch_norm, out)."""
    out = _copy(state, {"batch_norm": "batch_norm", "out": "out"})
    out.pop("batch_norm.num_batches_tracked", None)
    for layer in range(layers):
        for suffix in ("", "_reverse"):
            out.update(_lstm(state, "lstm", layer, suffix, f"rnn.{layer}.{{}}_l0{suffix}"))
    return out
