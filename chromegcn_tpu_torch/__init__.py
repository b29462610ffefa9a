"""PyTorch/CUDA port of chromegcn_tpu for NVIDIA Hopper (H100).

The JAX package ``chromegcn_tpu`` is the reference; this package imports
nothing of it (nor jax): importing any ``chromegcn_tpu`` module runs its
``__init__``, which imports jax. Host-side numpy code the port needs is
copied here.

Entry points (graph build, BSR attach, state creation, train/eval steps)
run on the card unless the caller passes ``device="cpu"``; on a machine
without CUDA the default raises instead of carrying on on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

__version__ = "0.1.0"

DeviceLike = Union[str, torch.device]


def default_device() -> torch.device:
    """The device entry points use when the caller names none: the card."""
    return torch.device("cuda")


def resolve_device(device: DeviceLike | None = None) -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and there is none."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "chromegcn_tpu_torch runs on a CUDA device by default, and "
            "torch.cuda.is_available() is False here; pass device='cpu' to "
            "run the plain PyTorch path on the CPU"
        )
    return dev
