"""Tensor parallelism for the window-model stage (port of
chromegcn_tpu/parallel/tp.py).

The reference's TP is a placement policy: every array of at least
``MIN_SHARD_ELEMENTS`` elements and two dimensions is sharded over the
``model`` mesh axis along its largest dimension that divides evenly, and
GSPMD propagates the layout through the jitted step, inserting the
contraction's psum. Here the same rule (``shard_large_arrays``) picks the
dimension, and each ``nn.Linear`` it shards along its in-features (as
Expecto's flatten-Dense, 960·C inputs, ``models/window.py``) becomes a
``RowParallelLinear`` over the model group: each model rank holds a
contiguous slice of the input columns and computes ``x[:, slice] @
W_slice``; an all-reduce over the model group sums the partial outputs,
its backward the identity (every rank holds the whole cotangent), and the
input's cotangent is summed over the group on the way back
(``parallel.mesh.copy_to_group``).

The port flattens channel-major (C L) where JAX flattens (L C), so a rank's
slice holds other weights than JAX's; the sum is the same. An array the
rule shards along another dimension (a convolution kernel; a Linear's
out-features, which no window model's layer of the rule's size has) stays
replicated here: a deliberate difference. Optimizer moments follow their
parameter's slice: ``place_window_state`` rebuilds the optimizer over the
sliced parameters and slices its state.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from chromegcn_tpu_torch.parallel.mesh import (
    Mesh, copy_to_group, gather_rows, group_rank, reduce_replicated, shard_batch,
)

# arrays at or above this element count get sharded; everything smaller is
# replicated (the reference's constant)
MIN_SHARD_ELEMENTS = 1 << 20


def shard_large_arrays(shapes: Mapping[str, Tuple[int, ...]], n_shards: int,
                       min_elements: int = MIN_SHARD_ELEMENTS) -> Dict[str, Optional[int]]:
    """The reference's rule: for each named shape, the dimension it is
    sharded over (the largest that ``n_shards`` divides, for arrays of >= 2
    dimensions and >= ``min_elements`` elements), or None (replicated)."""
    plan: Dict[str, Optional[int]] = {}
    for name, shape in shapes.items():
        plan[name] = None
        if len(shape) >= 2 and int(np.prod(shape)) >= min_elements:
            for dim in np.argsort(shape)[::-1]:
                if shape[dim] % n_shards == 0:
                    plan[name] = int(dim)
                    break
    return plan


class RowParallelLinear(nn.Module):
    """A Linear whose weight's input columns are sliced over ``group``:
    y = sum over the group of x[..., slice] @ W[:, slice]^T, plus the
    (replicated) bias."""

    def __init__(self, linear: nn.Linear, group):
        super().__init__()
        rank, world = group_rank(group)
        self.group, self.world = group, world
        self.in_features, self.out_features = linear.in_features, linear.out_features
        n = linear.in_features // world
        self.lo, self.hi = rank * n, (rank + 1) * n
        self.weight = nn.Parameter(linear.weight.detach()[:, self.lo:self.hi].clone())
        self.bias = nn.Parameter(linear.bias.detach().clone())

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"columns [{self.lo}, {self.hi}) of {self.world} ranks")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_group(x, self.group)
        part = F.linear(x[..., self.lo:self.hi], self.weight)
        return reduce_replicated(part, self.group) + self.bias


def _row_parallel(model: nn.Module):
    return [(n, m) for n, m in model.named_modules() if isinstance(m, RowParallelLinear)]


def place_window_state(state, mesh: Mesh, axis: str = "model",
                       min_elements: int = MIN_SHARD_ELEMENTS):
    """Make each Linear layer of a WindowTrainState that the reference's
    rule shards along its in-features row-parallel over ``mesh``'s
    ``axis``, in place of the model's module, and rebuild its optimizer
    over the new parameters with each weight's moments sliced as the weight
    is. Returns the state."""
    group = mesh.group(axis)
    n_shards = mesh.size(axis)
    model, opt = state.model, state.optimizer
    old = dict(model.named_parameters())
    old_state = {name: opt.state.get(p, {}) for name, p in old.items()}
    plan = shard_large_arrays({n: tuple(p.shape) for n, p in old.items()}, n_shards,
                              min_elements)
    if n_shards > 1:
        for name, module in list(model.named_modules()):
            # torch's Linear weight is (out, in): dim 1 is the in-features
            if not isinstance(module, nn.Linear) or plan.get(f"{name}.weight") != 1:
                continue
            parent_name, _, child = name.rpartition(".")
            parent = model.get_submodule(parent_name) if parent_name else model
            setattr(parent, child, RowParallelLinear(module, group))
    slices = {f"{n}.weight": (m.lo, m.hi) for n, m in _row_parallel(model)}
    new = dict(model.named_parameters())
    new_opt = type(opt)(list(new.values()), **opt.defaults)
    new_opt.param_groups[0].update(
        {k: v for k, v in opt.param_groups[0].items() if k != "params"})
    for name, p in new.items():
        moments = {}
        for key, value in old_state[name].items():
            if name in slices and torch.is_tensor(value) and value.shape == old[name].shape:
                lo, hi = slices[name]
                value = value[:, lo:hi]
            moments[key] = value.clone() if torch.is_tensor(value) else value
        if moments:
            new_opt.state[p] = moments
    state.optimizer = new_opt
    return state


def full_payload(state) -> dict:
    """The state's model and optimizer ``state_dict``s in the full (single
    device) layout: every sliced weight and its moments gathered over its
    group. A collective: every rank of the model group calls it."""
    model, opt = state.model, state.optimizer
    sd = model.state_dict()
    osd = opt.state_dict()
    names = [n for n, _ in model.named_parameters()]
    for prefix, m in _row_parallel(model):
        key = f"{prefix}.weight"
        sd[key] = gather_rows(sd[key], m.group, 1)
        moments = osd["state"].get(names.index(key), {})
        for k, v in moments.items():
            if torch.is_tensor(v) and v.shape == m.weight.shape:
                moments[k] = gather_rows(v, m.group, 1)
    return {"model": sd, "optimizer": osd}


def tp_batch_sharding(mesh: Mesh, data_axis: str = "data"):
    """Batches shard over the data axis only; activations stay replicated
    over the model axis until they meet a sharded layer."""
    return shard_batch(mesh, data_axis)
