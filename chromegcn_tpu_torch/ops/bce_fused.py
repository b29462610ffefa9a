"""The masked BCE-with-logits sum and its gradient through two hand-written
kernels (``csrc/bce_fused.cu``).

``train/loss.py:bce_with_logits`` is the mean over valid rows of
max(x, 0) - x z + log1p(exp(-|x|)). Its masked sum over the (N, L) logits,

    num = sum_r m_r sum_j [max(x, 0) - x z + log1p(exp(-|x|))],

is the part that reads every logit; its gradient is
dx = g m_r (sigmoid(x) - z) for the cotangent g of ``num``. For f32 logits
on the card, ``masked_bce_sum`` computes ``num`` in one read-only pass and
``dx`` in one elementwise pass (``BCESum``); on the CPU and in float64 it
runs the plain torch formula, ``bce_sum_plain``, under autograd. The count
and the mean stay in the caller, in torch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from chromegcn_tpu_torch.ops import _build

# five pointers, rows, L, the stream: both C entries
_ENTRY_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def bce_sum_plain(x: torch.Tensor, z: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """num by the torch formula: the CPU's and float64's path, and the
    kernels' yardstick. ``m`` is the (N,) row mask in ``x``'s dtype."""
    per_elem = x.clamp(min=0.0) - x * z + torch.log1p(torch.exp(-x.abs()))
    return (per_elem * m[:, None]).sum()


def bce_grad_plain(x: torch.Tensor, z: torch.Tensor, m: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """d num / dx times the cotangent ``g``, in closed form: g m (sigmoid(x) - z).
    The autograd chain of ``bce_sum_plain`` differs from it only at x == 0."""
    return g * m[:, None] * (torch.sigmoid(x) - z)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> Tuple[ctypes.CDLL, int]:
    """The library, its entries typed, and the doubles of scratch that
    ``bce_sum_f32`` takes (read once)."""
    lib = _build.load("bce_fused")
    for fn in (lib.bce_sum_f32, lib.bce_sum_bwd_f32):
        fn.argtypes, fn.restype = _ENTRY_ARGTYPES, ctypes.c_int
    lib.bce_sum_partials.argtypes, lib.bce_sum_partials.restype = [], ctypes.c_int
    return lib, lib.bce_sum_partials()


def _check(x: torch.Tensor, z: torch.Tensor, m: torch.Tensor) -> None:
    """The kernels' operands: f32, contiguous, on one card; x and z (N, L),
    m (N,)."""
    if x.device.type != "cuda":
        raise ValueError(f"the BCE kernels run on cuda tensors, got {x.device}")
    if x.dim() != 2 or tuple(z.shape) != tuple(x.shape) or tuple(m.shape) != (x.shape[0],):
        raise ValueError(f"logits (N, L), targets (N, L) and mask (N,), got "
                         f"{tuple(x.shape)}, {tuple(z.shape)} and {tuple(m.shape)}")
    for name, t in (("logits", x), ("targets", z), ("mask", m)):
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {x.device}, got "
                             f"{t.dtype} on {t.device}")


def bce_sum(x: torch.Tensor, z: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """num as an f32 scalar on the card, in one pass over x and z and a
    one-block sum of the blocks' float64 partials (two launches, counted in
    ``_build.LAUNCHES['bce_sum']``). Repeats bit for bit."""
    _check(x, z, m)
    lib, partials = _kernel_lib()
    partial = torch.empty(partials, dtype=torch.float64, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.bce_sum_f32(
            x.data_ptr(), z.data_ptr(), m.data_ptr(), partial.data_ptr(), out.data_ptr(),
            x.shape[0], x.shape[1], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "bce_sum", code)
    _build.LAUNCHES["bce_sum"] += 2
    return out


def bce_sum_bwd(x: torch.Tensor, z: torch.Tensor, m: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """dx = g m (sigmoid(x) - z) on the card in one pass, ``g`` a one-element
    f32 tensor read on the device (counted in ``_build.LAUNCHES['bce_sum_bwd']``)."""
    _check(x, z, m)
    if g.numel() != 1 or g.dtype != torch.float32 or g.device != x.device:
        raise ValueError(f"the cotangent must be one float32 on {x.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    lib, _ = _kernel_lib()
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.bce_sum_bwd_f32(
            x.data_ptr(), z.data_ptr(), m.data_ptr(), g.data_ptr(), dx.data_ptr(),
            x.shape[0], x.shape[1], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "bce_sum_bwd", code)
    _build.LAUNCHES["bce_sum_bwd"] += 1
    return dx


class BCESum(torch.autograd.Function):
    """num through ``bce_sum``; its backward through ``bce_sum_bwd``, which
    reads the logits and targets saved here and nothing else of (N, L). The
    targets and the mask get no gradient."""

    @staticmethod
    def forward(ctx, x, z, m):
        ctx.save_for_backward(x, z, m)
        return bce_sum(x, z, m)

    @staticmethod
    def backward(ctx, g):
        x, z, m = ctx.saved_tensors
        return bce_sum_bwd(x, z, m, g.to(torch.float32).contiguous()), None, None


def masked_bce_sum(x: torch.Tensor, z: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """num for logits ``x`` and targets ``z`` of one dtype and the (N,) row
    mask ``m`` in it: f32 logits on the card through the kernels; the CPU
    and float64 by the plain formula (chip_smoke.py's float64 train steps on
    the card are held to the CPU's within 1e-9). The kernels give the
    targets no gradient: targets that want one on the card are refused."""
    if x.device.type == "cpu" or x.dtype == torch.float64:
        return bce_sum_plain(x, z, m)
    if z.requires_grad:
        raise ValueError("the BCE kernels give the targets no gradient, and these want one")
    return BCESum.apply(x.contiguous(), z.contiguous(), m.contiguous())
