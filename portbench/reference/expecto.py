"""Plain PyTorch reference of the Expecto window model's train step (the
window CNN of https://github.com/QData/ChromeGCN README.md:34, after Zhou et
al. 2018), built from the configuration's ``layers`` list alone. It imports
nothing of the program.

Both strands run as one batch [tokens; reverse complement], so each
BatchNorm takes its statistics over both strands' rows (and positions),
with the biased variance; the logits are the mean of the two strands'. The
loss is the mean binary cross-entropy with logits. Dropout keeps a value
with probability 1 - p and scales it by 1 / (1 - p); its masks are
Bernoulli draws of the activation's shape, float32, from one generator, in
the order of the layer list.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

COMPLEMENT = {"a": "t", "t": "a", "c": "g", "g": "c", "n": "n"}


def flat_width(cfg: dict) -> int:
    """Channels x positions where the configuration flattens."""
    length, channels = cfg["seq_length"], None
    for layer in cfg["layers"]:
        if layer["op"] == "embed":
            channels = layer["dim"]
        elif layer["op"] == "conv":
            length, channels = length - layer["k"] + 1, layer["out"]
        elif layer["op"] == "maxpool":
            length //= layer["k"]
        elif layer["op"] == "flatten":
            return channels * length
    raise ValueError("the configuration never flattens")


def param_specs(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, std) of every trained parameter, in the order of
    the layer list; kind 'normal', 'ones' or 'zeros'."""
    specs = []
    for layer in cfg["layers"]:
        op, name = layer["op"], layer.get("name")
        if op == "embed":
            specs.append((f"{name}.weight", (layer["vocab"], layer["dim"]), "normal",
                          math.sqrt(1.0 / layer["dim"])))
        elif op == "conv":
            fan_in = layer["in"] * layer["k"]
            specs += [(f"{name}.weight", (layer["out"], layer["in"], layer["k"]), "normal",
                       math.sqrt(1.0 / fan_in)),
                      (f"{name}.bias", (layer["out"],), "zeros", 0.0)]
        elif op == "linear":
            fan_in = flat_width(cfg) if layer["in"] == "flat" else layer["in"]
            specs += [(f"{name}.weight", (layer["out"], fan_in), "normal",
                       math.sqrt(1.0 / fan_in)),
                      (f"{name}.bias", (layer["out"],), "zeros", 0.0)]
        elif op == "batch_norm":
            specs += [(f"{name}.weight", (layer["dim"],), "ones", 0.0),
                      (f"{name}.bias", (layer["dim"],), "zeros", 0.0)]
    return specs


def reverse_complement(tokens: torch.Tensor, vocab: Dict[str, int]) -> torch.Tensor:
    table = torch.arange(max(vocab.values()) + 1, device=tokens.device)
    for sym, idx in vocab.items():
        table[idx] = vocab[COMPLEMENT[sym]]
    return table[tokens.long().flip(-1)]


def logits(cfg: dict, w: Dict[str, torch.Tensor], tokens: torch.Tensor,
           gen: torch.Generator) -> torch.Tensor:
    """Training-mode logits of (B, L) tokens: the strands' mean."""
    b = tokens.shape[0]
    x = torch.cat([tokens.long(), reverse_complement(tokens, cfg["vocab"])])
    eps = cfg["batch_norm"]["eps"]
    for layer in cfg["layers"]:
        op, name = layer["op"], layer.get("name")
        if op == "embed":
            x = w[f"{name}.weight"][x].transpose(1, 2)
        elif op == "conv":
            x = F.conv1d(x, w[f"{name}.weight"], w[f"{name}.bias"])
        elif op == "relu":
            x = torch.relu(x)
        elif op == "maxpool":
            x = F.max_pool1d(x, layer["k"])
        elif op == "batch_norm":
            axes = [0] + list(range(2, x.dim()))
            mean = x.mean(axes, keepdim=True)
            var = (x - mean).square().mean(axes, keepdim=True)
            shape = [1, -1] + [1] * (x.dim() - 2)
            x = (x - mean) * torch.rsqrt(var + eps)
            x = x * w[f"{name}.weight"].view(shape) + w[f"{name}.bias"].view(shape)
        elif op == "dropout":
            keep = torch.empty(x.shape, dtype=torch.float32,
                               device=x.device).bernoulli_(1.0 - layer["p"], generator=gen)
            x = torch.where(keep.bool(), x / (1.0 - layer["p"]), torch.zeros_like(x))
        elif op == "flatten":
            x = x.flatten(1)
        elif op == "linear":
            x = x @ w[f"{name}.weight"].t() + w[f"{name}.bias"]
        else:
            raise ValueError(f"unknown layer {op!r}")
    return (x[:b] + x[b:]) / 2.0


def loss_fn(cfg: dict, batches: List[Dict[str, torch.Tensor]], dropout_seed: int, dtype,
            device, half_batch: bool = False):
    """``loss(w, i)``: step i's training loss on ``batches[i % len]`` (its
    ``tokens`` and ``targets``), the dropout generator carried from step to
    step. ``half_batch`` runs and averages the first half of the rows only
    (a planted fault)."""
    gen = torch.Generator(device=device).manual_seed(dropout_seed)

    def loss(w, i):
        batch = batches[i % len(batches)]
        tokens, targets = batch["tokens"], batch["targets"].to(dtype)
        if half_batch:
            half = tokens.shape[0] // 2
            tokens, targets = tokens[:half], targets[:half]
        return F.binary_cross_entropy_with_logits(logits(cfg, w, tokens, gen), targets)

    return loss
