"""Window-model (CNN) pretraining stage (port of
chromegcn_tpu/train/pretrain.py).

Train and eval steps over fixed-shape batches, each strand pair in one
NonStrandSpecific call, and the feature dump of ``-save_feats``: the
d_model features of both strands grouped by chromosome, the CNN->GCN file
contract (reference: pretrain.py:57-60, utils/util_methods.py:183-199).

The epoch keeps each step's loss, probabilities (and features) on the card
and copies them to the host every DRAIN_EVERY batches, as the JAX package
drains its dispatches (pretrain.py:141-154), so the host does not wait for
the card after every batch.

Data parallelism (``-dp_devices``): a state whose ``group`` is a process
group of data ranks trains on each rank's slice of every batch
(``parallel.multihost.host_batch_slice``); its BatchNorms take the global
batch's statistics (``models.norm.sync_batch_norm``), the masked loss is
the global mean, the gradients are summed over the group, and the epoch
gathers the predictions and features back, so every rank holds what one
device would.

Deliberate differences from the JAX package (jax.random draws cannot be
reproduced without jax): dropout masks come from a ``torch.Generator`` and
the shuffle order from a numpy generator, both seeded from ``-seed`` by the
runner.

f32 path: ``create_window_state`` turns TF32 off for CUDA matmuls, as
``create_chrome_state`` does for the GCN, and turns cuDNN off: with TF32 off,
cuDNN's f32 backward convolutions are still not f32-faithful on the H100
(at seq 2,000, DeepSEA's conv3 weight gradient lands 1.4e-3 of its scale
from float64 through cuDNN, 2.4e-2 with TF32, and within 1e-6 without
cuDNN; chip_smoke.py phase 11 records each mode). So
the convolutions run as PyTorch's im2col and cuBLAS f32 GEMMs
(``runner.apply_matmul_precision``'s fast mode, ``-matmul_precision
default``, turns cuDNN and TF32 back on). DanQ's LSTM runs through cuDNN's
RNN in either mode (models/chrome.py:lstm_forward).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from chromegcn_tpu_torch import DeviceLike, resolve_device
from chromegcn_tpu_torch.data.loader import ChromFeatures, WindowDataset, iterate_batches
from chromegcn_tpu_torch.models.norm import sync_batch_norm
from chromegcn_tpu_torch.models.strand import NonStrandSpecific
from chromegcn_tpu_torch.ops import _build
from chromegcn_tpu_torch.parallel.mesh import all_reduce_grads, gather_rows, group_rank
from chromegcn_tpu_torch.parallel.multihost import host_batch_slice
from chromegcn_tpu_torch.train.finetune import _on
from chromegcn_tpu_torch.train.loss import bce_with_logits
from chromegcn_tpu_torch.train.optim import make_optimizer
from chromegcn_tpu_torch.utils import profiling

# batches between two device-to-host copies of the epoch's step outputs
DRAIN_EVERY = 32


@dataclasses.dataclass
class WindowTrainState:
    model: NonStrandSpecific
    optimizer: torch.optim.Optimizer
    step: int = 0
    # the data-parallel process group, or None on one rank
    group: Optional[torch.distributed.ProcessGroup] = None


def data_parallel(state: WindowTrainState, group) -> WindowTrainState:
    """The state trained data-parallel over ``group``: BatchNorm statistics
    synced over it, the loss and the gradients reduced over it."""
    if group is not None:
        sync_batch_norm(state.model, group)
        state.group = group
    return state


def create_window_state(
    window_model: nn.Module,
    optimizer: str = "adam",
    lr: float = 2e-4,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> WindowTrainState:
    """Initialize ``window_model`` from ``seed`` (flax's initial
    distributions), wrap it in NonStrandSpecific on ``device`` and build its
    optimizer (train/optim.py)."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.enabled = False
    window_model.reset_parameters(torch.Generator().manual_seed(seed))
    model = NonStrandSpecific(window_model).to(device)
    return WindowTrainState(model=model, optimizer=make_optimizer(optimizer, lr, model.parameters()))


def window_train_step(
    state: WindowTrainState,
    tokens,
    targets,
    row_mask,
    comp_map: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = "cuda",
) -> Tuple[WindowTrainState, torch.Tensor, torch.Tensor]:
    """One optimizer step on one batch; returns (state, loss, sigmoid probs).

    BatchNorm statistics pool every row of the 2B strand batch, padding rows
    included (the window model gets no mask); only the loss excludes the
    rows ``row_mask`` marks False. Updates the model and optimizer in place;
    dropout masks come from ``generator``. Under data parallelism the
    arrays are this rank's rows of the batch, and the probabilities too.
    Spans as ``finetune.chrome_train_step``'s; the head is inside the
    model, so the first ``loss`` holds the loss alone."""
    device = resolve_device(device)
    tokens, targets, row_mask = _on(device, tokens, targets, row_mask)
    model, opt = state.model, state.optimizer
    model.train()
    with profiling.span("train_step", counters=_build.LAUNCHES):
        with profiling.span("optimizer"):
            opt.zero_grad(set_to_none=True)
        with profiling.span("forward"):
            _, _, logits = model(tokens, comp_map, generator=generator)
            with profiling.span("loss"):
                loss = bce_with_logits(logits, targets, row_mask, state.group)
        with profiling.span("backward"):
            loss.backward()
        if state.group is not None:
            with profiling.span("grad_allreduce"):
                all_reduce_grads(model.parameters(), state.group)
        with profiling.span("optimizer"):
            opt.step()
        with profiling.span("loss"):
            probs = torch.sigmoid(logits.detach())
    state.step += 1
    return state, loss.detach(), probs


@torch.no_grad()
def window_eval_step(
    state: WindowTrainState,
    tokens,
    targets,
    row_mask,
    comp_map: torch.Tensor,
    device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eval-mode forward with the running BatchNorm stats; returns (loss,
    probs, x_fwd, x_rev)."""
    device = resolve_device(device)
    tokens, targets, row_mask = _on(device, tokens, targets, row_mask)
    state.model.eval()
    with profiling.span("eval_step"):
        x_f, x_r, logits = state.model(tokens, comp_map)
        loss = bce_with_logits(logits, targets, row_mask, state.group)
        return loss, torch.sigmoid(logits), x_f, x_r


def run_window_epoch(
    state: WindowTrainState,
    dataset: WindowDataset,
    comp_map: torch.Tensor,
    batch_size: int,
    train: bool,
    generator: Optional[torch.Generator] = None,
    shuffle: Optional[bool] = None,
    shuffle_rng: Optional[np.random.Generator] = None,
    collect_features: bool = False,
    device: DeviceLike = "cuda",
) -> Tuple[WindowTrainState, np.ndarray, np.ndarray, float, Optional[Dict[str, ChromFeatures]]]:
    """One epoch over a split (reference: pretrain.py:109-185).

    Returns (state, preds, targets, total_loss, features_by_chrom) in
    dataset order; total_loss sums the per-batch mean losses (reference:
    pretrain.py:51). ``shuffle`` (default: ``train``) draws the order from
    ``shuffle_rng``; ``collect_features`` (eval mode) also returns both
    strands' features grouped by chromosome."""
    device = resolve_device(device)
    if collect_features and train:
        raise ValueError("collect_features needs an eval pass (train=False)")
    n = len(dataset)
    all_preds = np.zeros((n, dataset.n_targets), np.float32)
    all_targs = np.zeros((n, dataset.n_targets), np.float32)
    feats_f = feats_r = None
    total_loss = 0.0
    if shuffle is None:
        shuffle = train
    rng = shuffle_rng if shuffle_rng is not None else np.random.default_rng(0)
    pending = []  # (loss, probs, x_f, x_r, batch) on the card, not yet copied

    def drain():
        nonlocal total_loss, feats_f, feats_r
        if not pending:
            return
        losses = torch.stack([p[0] for p in pending]).cpu().numpy()
        probs = torch.stack([p[1] for p in pending]).cpu().numpy()
        if collect_features:
            xf = torch.stack([p[2] for p in pending]).cpu().numpy()
            xr = torch.stack([p[3] for p in pending]).cpu().numpy()
            if feats_f is None:
                feats_f = np.zeros((n, xf.shape[-1]), np.float32)
                feats_r = np.zeros((n, xf.shape[-1]), np.float32)
        for i, (*_, b) in enumerate(pending):
            total_loss += float(losses[i])
            rows = b.indices[b.row_mask]
            all_preds[rows] = probs[i][b.row_mask]
            all_targs[rows] = b.targets[b.row_mask]
            if collect_features:
                feats_f[rows] = xf[i][b.row_mask]
                feats_r[rows] = xr[i][b.row_mask]
        pending.clear()

    group = state.group
    rank, world = group_rank(group)
    lo, hi = host_batch_slice(batch_size, rank, world)
    for batch in iterate_batches(dataset, batch_size, shuffle=shuffle, rng=rng):
        x_f = x_r = None
        rows = (batch.tokens[lo:hi], batch.targets[lo:hi], batch.row_mask[lo:hi])
        if train:
            state, loss, probs = window_train_step(
                state, *rows, comp_map, generator, device=device,
            )
        else:
            loss, probs, x_f, x_r = window_eval_step(state, *rows, comp_map, device=device)
        if group is not None:
            probs = gather_rows(probs, group)
            if collect_features:
                x_f, x_r = gather_rows(x_f, group), gather_rows(x_r, group)
        pending.append((loss, probs, x_f, x_r, batch))
        if len(pending) >= DRAIN_EVERY:
            drain()
    drain()

    features = None
    if collect_features:
        features = group_features_by_chrom(dataset, feats_f, feats_r)
    return state, all_preds, all_targs, total_loss, features


def group_features_by_chrom(
    dataset: WindowDataset, feats_f: np.ndarray, feats_r: np.ndarray
) -> Dict[str, ChromFeatures]:
    """Group rows by chromosome, keeping dataset order (reference:
    utils/util_methods.py:183-199)."""
    out: Dict[str, ChromFeatures] = {}
    for chrom in dataset.chrom_order():
        idx = np.nonzero(dataset.chroms == chrom)[0]
        out[chrom] = ChromFeatures(
            forward=feats_f[idx],
            backward=feats_r[idx],
            target=dataset.targets[idx].astype(np.float32),
            starts=dataset.starts[idx],
        )
    return out
