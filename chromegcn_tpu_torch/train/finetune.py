"""Chromosome-model (GCN) training stage (port of
chromegcn_tpu/train/finetune.py).

Whole-chromosome forward/backward per optimizer step: the batch is a
chromosome (reference: finetune.py:29-49). Strands run as two sequential
weight-sharing passes through the same module, so BatchNorm running stats
update per pass; the head is linear, so it is applied once to the
strand-averaged penultimate features, which equals averaging the two
strands' logits (reference: finetune.py:41-45).

On a graph row-sharded over a process group (``parallel.graph.ShardedGraph``
with a ``group``) the steps take this rank's rows: the model's BatchNorm and
the loss reduce over the group, and after backward each parameter's
gradient is summed over it (``parallel.mesh.all_reduce_grads``), since each
rank holds its part of one global mean's gradient. ``run_chrome_epoch``
places each chromosome's rows with ``place`` and gathers the predictions.

f32 path: the reference runs its SpMM at Precision.HIGHEST and its GEMMs
f32-faithful, so ``create_chrome_state`` turns TF32 off for CUDA matmuls
and cuDNN (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``, process-wide).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from chromegcn_tpu_torch import DeviceLike, resolve_device
from chromegcn_tpu_torch.data.loader import ChromFeatures
from chromegcn_tpu_torch.models.chrome import LSTM_COUNTS
from chromegcn_tpu_torch.ops import _build
from chromegcn_tpu_torch.ops.sparse import SparseGraph
from chromegcn_tpu_torch.parallel.mesh import all_reduce_grads, gather_rows
from chromegcn_tpu_torch.train.loss import bce_with_logits
from chromegcn_tpu_torch.train.optim import make_optimizer
from chromegcn_tpu_torch.utils import profiling


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
    from ``generator`` (on the inputs' device). Spans (utils/profiling.py):
    ``train_step`` with the kernel launches it made (``_build.LAUNCHES``)
    and the LSTM sweeps and positions it ran (``chrome.LSTM_COUNTS``), over
    ``optimizer`` (zero_grad, then the step), ``forward`` (both strands, and
    ``loss``: the head and the loss), ``backward``, on a sharded graph
    ``grad_allreduce``, and a second ``loss`` (the probabilities, after the
    step)."""
    device = resolve_device(device)
    x_f, x_r, targets = _on(device, x_f, x_r, targets)
    model, opt = state.model, state.optimizer
    group = getattr(graph, "group", None)
    # LSTM_COUNTS first: LAUNCHES, a Counter, answers 0 for keys it lacks
    with profiling.span("train_step",
                        counters=collections.ChainMap(LSTM_COUNTS, _build.LAUNCHES)):
        with profiling.span("optimizer"):
            opt.zero_grad(set_to_none=True)
        with profiling.span("forward"):
            _, h_f, _ = model(x_f, graph, train=True, skip_head=True, generator=generator)
            _, h_r, _ = model(x_r, graph, train=True, skip_head=True, generator=generator)
            with profiling.span("loss"):
                pred = model.out((h_f + h_r) / 2.0)
                loss = bce_with_logits(pred, targets, graph.node_mask, group)
        with profiling.span("backward"):
            loss.backward()
        if group is not None:
            with profiling.span("grad_allreduce"):
                all_reduce_grads(model.parameters(), group)
        with profiling.span("optimizer"):
            opt.step()
        # after the backward, which would otherwise hold N x nclass more
        with profiling.span("loss"):
            probs = torch.sigmoid(pred.detach())
    state.step += 1
    return state, loss.detach(), probs


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
    with profiling.span("eval_step"):
        _, h_f, _ = model(x_f, graph, train=False, skip_head=True)
        _, h_r, _ = model(x_r, graph, train=False, skip_head=True)
        pred = model.out((h_f + h_r) / 2.0)
        loss = bce_with_logits(pred, targets, graph.node_mask, getattr(graph, "group", None))
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
    place=None,
) -> Tuple[ChromeTrainState, np.ndarray, np.ndarray, float]:
    """One epoch = one pass over all chromosomes of a split
    (reference: finetune.py:29-55). Returns dataset-order preds/targets and
    the summed loss. ``place`` picks this rank's rows of each padded array
    (``parallel.mesh.node_sharding``) where the graphs are row-sharded over
    a process group; the predictions are gathered back."""
    device = resolve_device(device)
    place = place or (lambda arr: arr)
    preds_parts, targ_parts, losses, valid_counts = [], [], [], []
    for chrom, cf in features.items():
        graph = graphs[chrom]
        n_pad = graph.n_nodes
        x_f = place(pad_rows(cf.forward, n_pad))
        x_r = place(pad_rows(cf.backward, n_pad))
        targets = place(pad_rows(cf.target, n_pad))
        if train:
            state, loss, probs = chrome_train_step(
                state, x_f, x_r, graph, targets, generator, device=device
            )
        else:
            loss, probs = chrome_eval_step(state, x_f, x_r, graph, targets, device=device)
        group = getattr(graph, "group", None)
        if group is not None:
            probs = gather_rows(probs, group)
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
