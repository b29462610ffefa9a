"""Chromosome-model (GCN) training stage (port of
chromegcn_tpu/train/finetune.py).

Whole-chromosome forward/backward per optimizer step: the batch is a
chromosome (reference: finetune.py:29-49). Strands run as two sequential
weight-sharing passes through the same module, so BatchNorm running stats
update per pass; the head is linear, so it is applied once to the
strand-averaged penultimate features, which equals averaging the two
strands' logits (reference: finetune.py:41-45).

f32 path: the reference runs its SpMM at Precision.HIGHEST and its GEMMs
f32-faithful, so ``create_chrome_state`` turns TF32 off for CUDA matmuls
and cuDNN (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``, process-wide).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from chromegcn_tpu_torch import DeviceLike, resolve_device
from chromegcn_tpu_torch.data.loader import ChromFeatures
from chromegcn_tpu_torch.ops.sparse import SparseGraph
from chromegcn_tpu_torch.train.loss import bce_with_logits
from chromegcn_tpu_torch.train.optim import make_optimizer


@dataclasses.dataclass
class ChromeTrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_chrome_state(
    chrome_model: nn.Module,
    optimizer: str = "sgd",
    lr: float = 0.25,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> ChromeTrainState:
    """Initialize ``chrome_model`` from ``seed`` on ``device`` and build its
    optimizer (train/optim.py)."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chrome_model.reset_parameters(torch.Generator().manual_seed(seed))
    chrome_model.to(device)
    return ChromeTrainState(
        model=chrome_model,
        optimizer=make_optimizer(optimizer, lr, chrome_model.parameters()),
    )


def warm_start_head_from_window(chrome_model: nn.Module, window_state: Dict[str, torch.Tensor]) -> None:
    """Initialize the GCN's output head and its BatchNorm from a trained
    window model, in place: ``out`` from the classifier's weight and bias,
    ``batch_norm`` from ``head_bn``'s weight, bias and running mean and var
    (reference: finetune.py:51-73; main.py:78-81 copies the classifier and
    the BatchNorm). ``window_state`` is the window model's ``state_dict``,
    bare or wrapped in NonStrandSpecific (keys under ``model.``).

    Only Expecto has both a ``classifier`` and a ``head_bn``: DeepSEA has no
    ``head_bn`` and DanQ neither. The JAX package stops there with a
    KeyError; so does this, naming what is missing."""
    inner = {k[len("model."):] if k.startswith("model.") else k: v
             for k, v in window_state.items()}
    sources = {
        "out.weight": "classifier.weight", "out.bias": "classifier.bias",
        "batch_norm.weight": "head_bn.weight", "batch_norm.bias": "head_bn.bias",
        "batch_norm.running_mean": "head_bn.running_mean",
        "batch_norm.running_var": "head_bn.running_var",
    }
    missing = [src for src in sources.values() if src not in inner]
    if missing:
        raise KeyError(
            f"the GCN head's warm start reads the window model's classifier and head_bn, "
            f"which only Expecto has; this window checkpoint lacks {missing}"
        )
    target = chrome_model.state_dict()
    for dst, src in sources.items():
        if target[dst].shape != inner[src].shape:
            raise ValueError(
                f"warm start: {src} {tuple(inner[src].shape)} does not fit {dst} "
                f"{tuple(target[dst].shape)}"
            )
    with torch.no_grad():
        for dst, src in sources.items():
            target[dst].copy_(inner[src])


def _on(device: torch.device, *arrays):
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def chrome_train_step(
    state: ChromeTrainState,
    x_f,
    x_r,
    graph: SparseGraph,
    targets,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = "cuda",
) -> Tuple[ChromeTrainState, torch.Tensor, torch.Tensor]:
    """One chromosome, one optimizer step; returns (state, loss, probs).

    Updates the state's model and optimizer in place. Dropout masks come
    from ``generator`` (on the inputs' device)."""
    device = resolve_device(device)
    x_f, x_r, targets = _on(device, x_f, x_r, targets)
    model, opt = state.model, state.optimizer
    opt.zero_grad(set_to_none=True)
    _, h_f, _ = model(x_f, graph, train=True, skip_head=True, generator=generator)
    _, h_r, _ = model(x_r, graph, train=True, skip_head=True, generator=generator)
    pred = model.out((h_f + h_r) / 2.0)
    loss = bce_with_logits(pred, targets, graph.node_mask)
    loss.backward()
    opt.step()
    state.step += 1
    return state, loss.detach(), torch.sigmoid(pred.detach())


@torch.no_grad()
def chrome_eval_step(
    state: ChromeTrainState,
    x_f,
    x_r,
    graph: SparseGraph,
    targets,
    device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward half of the step with running BatchNorm stats; (loss, probs)."""
    device = resolve_device(device)
    x_f, x_r, targets = _on(device, x_f, x_r, targets)
    model = state.model
    _, h_f, _ = model(x_f, graph, train=False, skip_head=True)
    _, h_r, _ = model(x_r, graph, train=False, skip_head=True)
    pred = model.out((h_f + h_r) / 2.0)
    loss = bce_with_logits(pred, targets, graph.node_mask)
    return loss, torch.sigmoid(pred)


def bucket_nodes(n: int, bucket: int = 2048) -> int:
    """Round a node count up to a bucket boundary."""
    return int(-(-n // bucket) * bucket)


def pad_rows(arr: np.ndarray, n_pad: int) -> np.ndarray:
    if arr.shape[0] == n_pad:
        return arr
    out = np.zeros((n_pad,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def run_chrome_epoch(
    state: ChromeTrainState,
    features: Dict[str, ChromFeatures],
    graphs: Dict[str, SparseGraph],
    train: bool,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = "cuda",
) -> Tuple[ChromeTrainState, np.ndarray, np.ndarray, float]:
    """One epoch = one pass over all chromosomes of a split
    (reference: finetune.py:29-55). Returns dataset-order preds/targets and
    the summed loss."""
    device = resolve_device(device)
    preds_parts, targ_parts, losses, valid_counts = [], [], [], []
    for chrom, cf in features.items():
        graph = graphs[chrom]
        n_pad = graph.n_nodes
        x_f = pad_rows(cf.forward, n_pad)
        x_r = pad_rows(cf.backward, n_pad)
        targets = pad_rows(cf.target, n_pad)
        if train:
            state, loss, probs = chrome_train_step(
                state, x_f, x_r, graph, targets, generator, device=device
            )
        else:
            loss, probs = chrome_eval_step(state, x_f, x_r, graph, targets, device=device)
        # keep device tensors; one copy after the loop lets the steps queue
        preds_parts.append(probs)
        targ_parts.append(cf.target[: cf.forward.shape[0]])
        valid_counts.append(cf.forward.shape[0])
        losses.append(loss)
    preds = np.concatenate(
        [p[:n].cpu().numpy() for p, n in zip(preds_parts, valid_counts)], axis=0
    )
    return (
        state,
        preds,
        np.concatenate(targ_parts, axis=0),
        float(torch.stack(losses).sum()),
    )
