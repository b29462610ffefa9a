"""Checkpoints of both stages (port of chromegcn_tpu/train/checkpoint.py,
in torch's own format): the window model's in stage 1's run directory, the
GCN's in the finetune run directory.

A checkpoint is one ``torch.save`` file holding the model's ``state_dict``
(parameters and BatchNorm running statistics), the optimizer's
``state_dict``, the epoch and the selection score, so a run resumes where
it stopped. The save modes are the reference's (``-save_mode``,
reference: train/checkpoint.py:34-37): ``best`` writes ``ckpt.pt``, ``all``
writes ``ckpt_epoch{E}_score{S}.pt``. The ``.pt`` suffix keeps the file
apart from the JAX package's orbax ``ckpt/`` directory in the same run
directory.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

CKPT = "ckpt.pt"
# the JAX package's checkpoint: an orbax directory of this name
ORBAX_CKPT = "ckpt"


def save_checkpoint(
    run_dir: str,
    state,
    epoch: int,
    save_mode: str = "best",
    score: Optional[float] = None,
) -> str:
    """Write ``state`` (a WindowTrainState or ChromeTrainState: its model
    and optimizer) and the epoch; returns the path."""
    if save_mode == "all" and score is not None:
        name = f"ckpt_epoch{epoch}_score{100 * score:.3f}.pt"
    else:
        name = CKPT
    path = os.path.join(run_dir, name)
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "epoch": int(epoch),
        "score": None if score is None else float(score),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a reader never sees half a file
    return path


def restore_checkpoint(run_dir: str, name: str = CKPT,
                       device: Optional[torch.device] = None) -> Dict[str, Any]:
    """The saved payload, tensors on ``device``."""
    return torch.load(os.path.join(run_dir, name), map_location=device, weights_only=True)


def checkpoint_exists(run_dir: str, name: str = CKPT) -> bool:
    return os.path.isfile(os.path.join(run_dir, name))


def any_checkpoint_exists(run_dir: str) -> bool:
    """A checkpoint of either package: the port's file or an orbax directory."""
    return checkpoint_exists(run_dir) or os.path.isdir(os.path.join(run_dir, ORBAX_CKPT))
