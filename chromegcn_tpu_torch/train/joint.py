"""Joint CNN+GCN training: one optimizer step trains both stages (port of
chromegcn_tpu/train/joint.py).

Per step, one chromosome's N_pad windows run through the window CNN in
chunks of ``chunk_size`` windows, one NonStrandSpecific call (a 2·chunk
strand batch) per chunk under ``torch.utils.checkpoint``: the chunk's
activations are recomputed in the backward pass, so memory holds one chunk
at a time (the reference's ``jax.checkpoint`` + ``lax.map``). The (N, d)
features of both strands then go through the chrome model's two strand
passes, the head is applied once to the strand-averaged features, and the
masked BCE backpropagates through both stages; both optimizers step.

On a graph row-sharded over a process group (``-graph_devices``, each rank
one shard) each rank runs the CNN over its own rows' chunks, so the
features come out sharded as the sharded GCN reads them (the reference's
shard_map over the chunk loop, joint.py:33-77); the loss reduces over the
group and both models' gradients are summed over it after backward.

The CNN runs in eval mode with its parameters trainable: frozen BatchNorm
statistics and no dropout. This follows the reference's code, which calls
the window model with ``train=False`` (joint.py:54), not its docstring
(:16-18), which says the dropout stays active.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from chromegcn_tpu_torch import DeviceLike, resolve_device
from chromegcn_tpu_torch.ops.sparse import SparseGraph
from chromegcn_tpu_torch.parallel.graph import ShardedGraph
from chromegcn_tpu_torch.parallel.mesh import all_reduce_grads
from chromegcn_tpu_torch.train.finetune import ChromeTrainState, _on
from chromegcn_tpu_torch.train.loss import bce_with_logits
from chromegcn_tpu_torch.train.pretrain import WindowTrainState


def _cnn_features(window_model, tokens: torch.Tensor, comp_map: torch.Tensor,
                  chunk_size: int, graph, remat: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both strands' (N, d) features of a chromosome's (N, L) tokens, in
    chunks of ``chunk_size`` windows; each chunk is recomputed in the
    backward pass where autograd records and ``remat`` is on. On a
    row-sharded graph ``tokens`` are this rank's rows."""
    if not isinstance(graph, (SparseGraph, ShardedGraph)):
        raise TypeError(f"joint mode takes a SparseGraph or a ShardedGraph, got {type(graph)}")
    n = tokens.shape[0]
    if n % chunk_size:
        raise ValueError(f"pad the node count ({n}) to a multiple of chunk_size ({chunk_size})")

    def chunk(toks):
        x_f, x_r, _ = window_model(toks, comp_map)
        return x_f, x_r

    parts = [checkpoint(chunk, toks, use_reentrant=False)
             if remat and torch.is_grad_enabled() else chunk(toks)
             for toks in tokens.split(chunk_size)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def joint_loss(wstate: WindowTrainState, cstate: ChromeTrainState, tokens, comp_map,
               graph: SparseGraph, targets, generator=None, chunk_size: int = 128,
               train: bool = True, remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, logits) of one chromosome through both stages, tensors on the
    models' device. ``train`` selects the chrome model's batch statistics
    (updated once per strand, in order) and its dropout; the CNN is always
    in eval mode."""
    wstate.model.eval()
    x_f, x_r = _cnn_features(wstate.model, tokens, comp_map, chunk_size, graph, remat)
    model = cstate.model
    gen = generator if train else None
    _, h_f, _ = model(x_f, graph, train=train, skip_head=True, generator=gen)
    _, h_r, _ = model(x_r, graph, train=train, skip_head=True, generator=gen)
    # the head is linear: once over the strand average = the average of the
    # strands' logits (train/finetune.py)
    pred = model.out((h_f + h_r) / 2.0)
    return bce_with_logits(pred, targets, graph.node_mask, getattr(graph, "group", None)), pred


def joint_train_step(
    wstate: WindowTrainState,
    cstate: ChromeTrainState,
    tokens,
    comp_map: torch.Tensor,
    graph: SparseGraph,
    targets,
    generator=None,
    chunk_size: int = 128,
    device: DeviceLike = "cuda",
) -> Tuple[WindowTrainState, ChromeTrainState, torch.Tensor]:
    """One chromosome, one joint optimizer step over both stages (reference:
    joint.py:80-126); returns (wstate, cstate, loss). Updates both models and
    optimizers in place; the chrome model's dropout masks come from
    ``generator``."""
    device = resolve_device(device)
    tokens, targets = _on(device, tokens, targets)
    wstate.optimizer.zero_grad(set_to_none=True)
    cstate.optimizer.zero_grad(set_to_none=True)
    loss, _ = joint_loss(wstate, cstate, tokens, comp_map, graph, targets, generator,
                         chunk_size)
    loss.backward()
    group = getattr(graph, "group", None)
    all_reduce_grads(list(wstate.model.parameters()) + list(cstate.model.parameters()), group)
    wstate.optimizer.step()
    cstate.optimizer.step()
    wstate.step += 1
    cstate.step += 1
    return wstate, cstate, loss.detach()


@torch.no_grad()
def joint_eval_step(
    wstate: WindowTrainState,
    cstate: ChromeTrainState,
    tokens,
    comp_map: torch.Tensor,
    graph: SparseGraph,
    targets,
    chunk_size: int = 128,
    device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode joint forward of one chromosome: (loss, probs) (reference:
    joint.py:129-153)."""
    device = resolve_device(device)
    tokens, targets = _on(device, tokens, targets)
    loss, pred = joint_loss(wstate, cstate, tokens, comp_map, graph, targets,
                            chunk_size=chunk_size, train=False)
    return loss, torch.sigmoid(pred)
