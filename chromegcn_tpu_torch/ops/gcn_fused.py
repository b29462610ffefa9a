"""Fused gated-GCN layer (port of chromegcn_tpu/ops/gcn_fused.py).

The unfused layer (models/chrome.py) runs ``z = tanh(A (x W) + b)``, the
gate ``g = sigmoid(z u + bu)`` and the lerp ``x_next = (1 - g) x + g z``.
This module computes the same layer with two hand-written kernels, which
replace the TPU kernels of the reference:

- ``fused_fwd`` (B2, ``_fused_fwd_call``; ``csrc/gcn_fused.cu``):
  ``z = tanh((A @ x) W + b)``. By associativity A (x W) == (A x) W, so the
  block stream runs against x directly and the GEMM, bias and tanh are the
  kernel's epilogue;
- ``fused_bwd`` (B3, ``_fused_bwd_call``; ``csrc/gcn_fused_bwd.cu``):
  ``h = A^T ds`` gathered over the transposed direction's edge form, then
  ``dx = dx_dir + h W^T`` on tensor cores in 3xTF32.

The gate, the lerp and the cotangent algebra of the backward pass (ds, db,
du, dbu, dx_dir, and dW = x^T h after B3) stay plain torch, as they stay in
XLA in the reference (:341-364). The operator gets no gradient.

``fused_fits`` is B2's limit: the tile heights it is built for, and a
shared-memory plan (a tile_r x d accumulator beside the block stream's
staging buffers) that fits one CTA on the card. B3 reads no tiles; its plan
(``bwd_smem_bytes``) fits at every width ``fused_fits`` admits. The
reference's VMEM budget does not apply here. Where ``fused_fits`` says no,
the model takes the unfused path, as the reference does.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from chromegcn_tpu_torch.ops import _build
from chromegcn_tpu_torch.ops.spmm_bsr import (
    STRIP_R, TILE_C, BSRMatrix, BSROperator, _check_csr, _check_dense, _check_x,
    bsr_matmul_plain,
)

FUSED_TILE_ROWS = (32, 64, 128)  # tile heights csrc/gcn_fused.cu is built for
SMEM_LIMIT = 232_448  # bytes of shared memory one CTA may use on an H100
_SLICE = 64  # output columns per slice of the block stream (bsr_stream.cuh DC)
# B3's W chunk (csrc/gcn_fused_bwd.cu NC x KC, rows padded to KC + 4 floats)
_BWD_NC, _BWD_KC = 64, 32


def smem_bytes(tile_r: int, d: int) -> int:
    """Shared memory of one B2 CTA: the block stream's staged tile
    (tile_r x 132), x block (128 x 64) and strip (8 x 128), and the
    tile_r x (d padded to 64, + 4) accumulator (csrc/gcn_fused.cu)."""
    width = -(-d // _SLICE) * _SLICE
    floats = tile_r * (TILE_C + 4) + TILE_C * _SLICE + STRIP_R * TILE_C + tile_r * (width + 4)
    return 4 * floats


def bwd_rows_per_cta(d: int) -> int:
    """Rows of h one B3 CTA gathers and multiplies at width ``d``."""
    return 64 if d <= 256 else (32 if d <= 640 else 16)


def bwd_smem_bytes(d: int) -> int:
    """Shared memory of one B3 CTA: its rows of h, (d padded to 32, + 4)
    floats each, and two W chunks (csrc/gcn_fused_bwd.cu)."""
    k_extent = -(-d // _BWD_KC) * _BWD_KC
    return 4 * (bwd_rows_per_cta(d) * (k_extent + 4) + 2 * _BWD_NC * (_BWD_KC + 4))


def _matrix_fits(m: BSRMatrix, d: int) -> bool:
    return (
        m.tile_c == TILE_C and m.tile_r in FUSED_TILE_ROWS and d > 0 and d % 4 == 0
        and smem_bytes(m.tile_r, d) <= SMEM_LIMIT
    )


def fused_fits(op, d: int) -> bool:
    """Whether the fused kernels take this operator at width ``d``."""
    return isinstance(op, BSROperator) and _matrix_fits(op.fwd, d) and _matrix_fits(op.bwd, d)


# ---------------------------------------------------------------------------
# Plain versions, kernel wrappers
# ---------------------------------------------------------------------------


def fused_fwd_plain(m: BSRMatrix, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """z = tanh((A @ x) w + b) in plain PyTorch: B2's reference, and its
    version for CPU tensors."""
    return torch.tanh(bsr_matmul_plain(m, x) @ w + b)


def fused_bwd_plain(
    m: BSRMatrix, ds: torch.Tensor, dx_dir: torch.Tensor, w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h, dx) = (A^T ds, dx_dir + h w^T) with ``m`` the transposed tiling:
    B3's reference, and its version for CPU tensors."""
    h = bsr_matmul_plain(m, ds)
    return h, dx_dir + h @ w.T


_PTR = ctypes.c_void_p
_FWD_ARGTYPES = [_PTR] * 12 + [ctypes.c_int] * 3 + [_PTR]
_BWD_ARGTYPES = [_PTR] * 8 + [ctypes.c_int] * 2 + [_PTR]


def _kernel_lib() -> ctypes.CDLL:
    """B2's library (csrc/gcn_fused.cu)."""
    lib = _build.load("gcn_fused")
    for fn in (lib.gcn_fused_fwd_f32, lib.gcn_fused_fwd_bf16):
        fn.argtypes, fn.restype = _FWD_ARGTYPES, ctypes.c_int
    lib.gcn_fused_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.gcn_fused_smem_bytes.restype = ctypes.c_longlong
    return lib


def _bwd_kernel_lib() -> ctypes.CDLL:
    """B3's library (csrc/gcn_fused_bwd.cu)."""
    lib = _build.load("gcn_fused_bwd")
    for fn in (lib.gcn_fused_bwd_f32, lib.gcn_fused_bwd_bf16):
        fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    lib.gcn_fused_bwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.gcn_fused_bwd_smem_bytes.restype = ctypes.c_longlong
    return lib


_BLOCK_FIELDS = ("tiles", "tile_cb", "tile_ptr", "strips", "strip_rb", "strip_cb",
                 "strip_ptr", "strip_order")


def _check_blocks(m: BSRMatrix, x: torch.Tensor) -> int:
    """B2's checks of the block arrays it walks and of its plan; returns d."""
    d = _check_x(m, x)
    if m.tiles.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"B2 takes float32 or bfloat16 tiles, got {m.tiles.dtype}")
    if not _matrix_fits(m, d):
        raise NotImplementedError(
            f"B2 takes tile_c={TILE_C}, tile_r in {FUSED_TILE_ROWS} and a "
            f"width whose plan fits {SMEM_LIMIT} bytes of shared memory; got "
            f"tile_r={m.tile_r}, d={d} ({smem_bytes(m.tile_r, d)} bytes)"
        )
    for name in _BLOCK_FIELDS:
        t = getattr(m, name)
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"BSRMatrix.{name} must be contiguous on {x.device}")
        if t.numel() and t.data_ptr() % 16:
            raise ValueError(f"BSRMatrix.{name} is not 16-byte aligned")
    return d


def fused_fwd(m: BSRMatrix, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """z = tanh((A @ x) w + b), A = ``m``. A CUDA tensor goes through kernel
    B2 or raises; a CPU tensor takes the plain version. Counts each launch
    in ``_build.LAUNCHES['gcn_fused_fwd']``."""
    if x.device.type == "cpu":
        return fused_fwd_plain(m, x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"fused_fwd runs on cuda or cpu tensors, got {x.device}")
    d = _check_blocks(m, x)
    _check_dense("w", w, (d, d), x.device)
    _check_dense("b", b, (d,), x.device)
    lib = _kernel_lib()
    entry = lib.gcn_fused_fwd_bf16 if m.tiles.dtype == torch.bfloat16 else lib.gcn_fused_fwd_f32
    z = torch.empty((m.n_rows, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = entry(
            *(getattr(m, name).data_ptr() for name in _BLOCK_FIELDS),
            x.data_ptr(), w.data_ptr(), b.data_ptr(), z.data_ptr(),
            m.n_rows // m.tile_r, m.tile_r, d,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, "gcn_fused_fwd", code)
    _build.LAUNCHES["gcn_fused_fwd"] += 1
    return z


def fused_bwd(
    m: BSRMatrix, ds: torch.Tensor, dx_dir: torch.Tensor, w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h, dx) = (A^T ds, dx_dir + h w^T), ``m`` the transposed direction.
    A CUDA tensor goes through kernel B3 (over ``m``'s edge form) or raises;
    a CPU tensor takes the plain version. Counts each launch in
    ``_build.LAUNCHES['gcn_fused_bwd']``."""
    if ds.device.type == "cpu":
        return fused_bwd_plain(m, ds, dx_dir, w)
    if ds.device.type != "cuda":
        raise ValueError(f"fused_bwd runs on cuda or cpu tensors, got {ds.device}")
    d = _check_csr(m, ds)
    if bwd_smem_bytes(d) > SMEM_LIMIT:
        raise NotImplementedError(
            f"B3's plan at d={d} takes {bwd_smem_bytes(d)} bytes of shared memory, "
            f"over {SMEM_LIMIT}"
        )
    _check_dense("w", w, (d, d), ds.device)
    _check_dense("dx_dir", dx_dir, (m.n_rows, d), ds.device)
    lib = _bwd_kernel_lib()
    entry = lib.gcn_fused_bwd_bf16 if m.val.dtype == torch.bfloat16 else lib.gcn_fused_bwd_f32
    h = torch.empty((m.n_rows, d), dtype=torch.float32, device=ds.device)
    dx = torch.empty_like(h)
    with torch.cuda.device(ds.device):
        code = entry(
            m.row_ptr.data_ptr(), m.col.data_ptr(), m.val.data_ptr(), ds.data_ptr(),
            dx_dir.data_ptr(), w.data_ptr(), h.data_ptr(), dx.data_ptr(), m.n_rows, d,
            torch.cuda.current_stream(ds.device).cuda_stream,
        )
    _build.check(lib, "gcn_fused_bwd", code)
    _build.LAUNCHES["gcn_fused_bwd"] += 1
    return h, dx


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------


class FusedGatedLayer(torch.autograd.Function):
    """(x_next, z, g) of one gated GCN layer over a flat BSR operator; the
    reference's ``fused_gated_layer`` custom VJP (:318-367).

    ``u`` is the gate's (d, 1) kernel, ``bu`` its (1,) bias. The backward
    pass takes every output's cotangent (torch hands zeros for an unused
    one) and runs B3 for A^T ds and dx."""

    @staticmethod
    def forward(ctx, op: BSROperator, x, w, b, u, bu):
        x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
        z = fused_fwd(op.fwd, x, w, b)
        g = torch.sigmoid(z @ u + bu)
        ctx.op = op
        ctx.save_for_backward(x, w, u, z, g)
        return (1.0 - g) * x + g * z, z, g

    @staticmethod
    def backward(ctx, dxn, dz_cot, dg_cot):
        x, w, u, z, g = ctx.saved_tensors
        # cotangent algebra of the gate and the lerp (reference :351-359)
        dg = torch.sum(dxn * (z - x), dim=1, keepdim=True) + dg_cot
        dt = dg * g * (1.0 - g)
        dz = g * dxn + dz_cot + dt * u.reshape(1, -1)
        ds = dz * (1.0 - z * z)
        db = ds.sum(0)
        du = z.T @ dt
        dbu = dt.sum(0)
        dx_dir = (1.0 - g) * dxn
        h, dx = fused_bwd(ctx.op.bwd, ds.contiguous(), dx_dir.contiguous(), w)
        dw = x.T @ h
        return None, dx, dw, db, du, dbu


def fused_gated_layer(
    op: BSROperator, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    u: torch.Tensor, bu: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x_next, z, g): z = tanh(A (x w) + b), g = sigmoid(z u + bu),
    x_next = (1 - g) x + g z, through kernels B2 and B3."""
    return FusedGatedLayer.apply(op, x, w, b, u, bu)
