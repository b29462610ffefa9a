"""Sparse SpMM over the block-sparse operator (port of
chromegcn_tpu/ops/spmm_pallas.py).

The adjacency is converted on the host into two dense block populations,
as the reference builds them:

- **tiles**: (tile_r x 128) dense blocks for every region with enough edges;
- **strips**: (8 x 128) mini-blocks for the stragglers. Every edge not in a
  tile falls in exactly one strip, so there is no COO remainder.

The host arrays (``tiles``, ``tile_rb``, ``tile_cb``, ``strips``,
``strip_rb``, ``strip_cb``, ``live``) equal the JAX builder's, padding
included: block counts are bucketed with zero blocks at (0, 0). The port
adds the live counts ``nt``/``ns``.

Each direction also carries its **edge form** (CSR: ``row_ptr``, ``col``,
``val``), built from exactly the nonzeros written into the live blocks.
Every kernel on the card gathers over it: the SpMM kernel
(``csrc/bsr_spmm.cu``, which replaces the TPU kernel ``_bsr_matmul``) and
the fused layer's kernels B2 and B3. The blocks hold ~50 stored elements
per edge on a Hi-C graph, and the product is bound by the bytes it moves.
The plain versions read the blocks, so they stay an oracle independent of
the edge form.

The tile/strip split constants are the reference's, kept so the arrays
match; a split tuned for the H100 is a separate, later option. The card
has no VMEM budget, so ``attach_bsr`` always builds the flat form (the
reference's panelled form for oversized graphs is not ported yet).

Backward: dX = A^T g. The transposed tiling is built on the host and
stored beside the forward one; ``SpmmBSR`` runs the same kernel over it,
and the operator gets no gradient.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Union

import numpy as np
import torch

from chromegcn_tpu_torch import DeviceLike, resolve_device
from chromegcn_tpu_torch.ops import _build
from chromegcn_tpu_torch.ops.sparse import SparseGraph

TILE = 128       # default tile row height
TILE_C = 128     # tile/strip column width (the kernel's x block height)
STRIP_R = 8      # strip row height
# 'auto' split break-even: densify a 128x128 region when it holds >= this
# many occupied strips (the reference's TPU-measured tile/strip cost ratio)
AUTO_BREAKEVEN_STRIPS = 6
# the reference's grid-step widths; they set the bucketed ``live`` counts
TILES_PER_STEP = 8
STRIPS_PER_STEP = 32

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class BSRMatrix:
    """Flat-list block-sparse matrix (one direction: A or A^T), (n_rows x n_cols)."""

    tiles: torch.Tensor      # (nt_pad, tile_r, tile_c) dense tiles
    tile_rb: torch.Tensor    # (nt_pad,) int32 tile row-block index (sorted)
    tile_cb: torch.Tensor    # (nt_pad,) int32 tile col-block index
    strips: torch.Tensor     # (ns_pad, 8, tile_c) dense strips for straggler edges
    strip_rb: torch.Tensor   # (ns_pad,) int32 strip row-block index (units of 8 rows)
    strip_cb: torch.Tensor   # (ns_pad,) int32 strip col-block index (units of tile_c)
    live: torch.Tensor       # (2,) int32 live [tile steps, strip steps] of the reference grid
    row_ptr: torch.Tensor    # (n_rows + 1,) int32 CSR: row i's entries are [row_ptr[i], row_ptr[i+1])
    col: torch.Tensor        # (nnz,) int32 column of each entry, ascending within a row
    val: torch.Tensor        # (nnz,) value of each entry, in the tiles' dtype
    nt: int                  # live tiles (the rest is padding)
    ns: int                  # live strips
    n_rows: int
    n_cols: int
    tile_r: int
    tile_c: int

    @property
    def n_nodes(self) -> int:
        return self.n_rows

    @property
    def nnz(self) -> int:
        """Stored nonzeros of the live blocks (the edge form's entries)."""
        return self.col.numel()

    def to(self, device: DeviceLike) -> "BSRMatrix":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


@dataclasses.dataclass
class BSROperator:
    """Forward + transposed block-sparse forms of one adjacency."""

    fwd: BSRMatrix
    bwd: BSRMatrix  # A^T

    @property
    def n_nodes(self) -> int:
        return self.fwd.n_rows

    def to(self, device: DeviceLike) -> "BSROperator":
        return BSROperator(fwd=self.fwd.to(device), bwd=self.bwd.to(device))


# ---------------------------------------------------------------------------
# Host-side conversion
# ---------------------------------------------------------------------------


def _bucket(n: int, mult: int) -> int:
    return int(np.ceil(max(n, 1) / mult) * mult)


def _build_one_direction(
    senders: np.ndarray,
    receivers: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    tile_r: int,
    tile_c: int,
    min_edges_per_tile: Union[int, str],
    dtype: torch.dtype,
    device: torch.device,
    n_cols: int | None = None,
) -> BSRMatrix:
    """senders index columns [0, n_cols); receivers index rows [0, n_rows)."""
    if n_cols is None:
        n_cols = n_rows
    ncb = n_cols // tile_c

    rb = receivers // tile_r
    cb = senders // tile_c
    key = rb.astype(np.int64) * ncb + cb.astype(np.int64)
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    if min_edges_per_tile == "auto":
        # densify a tile region when covering its edges with (8 x tile_c)
        # strips would cost more than one tile; k = occupied strip slots
        strip_key = (receivers // STRIP_R).astype(np.int64) * ncb + cb
        uniq_strips = np.unique(strip_key)
        tile_of_strip = (
            (uniq_strips // ncb) // (tile_r // STRIP_R)
        ) * ncb + uniq_strips % ncb
        tkeys, k_strips = np.unique(tile_of_strip, return_counts=True)
        k = k_strips[np.searchsorted(tkeys, uniq)]
        # break-even scaled with tile area relative to 128x128, rounded up
        is_dense = k >= max(
            1, -(-AUTO_BREAKEVEN_STRIPS * (tile_r * tile_c) // (128 * 128))
        )
    else:
        is_dense = counts >= min_edges_per_tile

    dense_keys = np.sort(uniq[is_dense])
    nt = len(dense_keys)
    # padding: zero tiles at (0, 0); the no-tiles case pads to one step
    nt_pad = TILES_PER_STEP if nt == 0 else _bucket(nt, 128)

    in_dense = is_dense[inv]
    se = np.nonzero(~in_dense)[0]
    ss, sr, sv = senders[se], receivers[se], vals[se]
    skey = (sr // STRIP_R).astype(np.int64) * ncb + (ss // tile_c).astype(np.int64)
    strip_keys = np.sort(np.unique(skey)) if len(skey) else np.zeros(0, np.int64)
    ns = len(strip_keys)
    ns_pad = _bucket(ns, 128)

    tiles = np.zeros((nt_pad, tile_r, tile_c), np.float32)
    tile_rb = np.zeros(nt_pad, np.int32)
    tile_cb = np.zeros(nt_pad, np.int32)
    tile_rb[:nt] = (dense_keys // ncb).astype(np.int32)
    tile_cb[:nt] = (dense_keys % ncb).astype(np.int32)
    de = np.nonzero(in_dense)[0]
    if len(de):
        tidx = np.searchsorted(dense_keys, key[de])
        np.add.at(tiles, (tidx, receivers[de] % tile_r, senders[de] % tile_c), vals[de])
    strips = np.zeros((ns_pad, STRIP_R, tile_c), np.float32)
    strip_rb = np.zeros(ns_pad, np.int32)
    strip_cb = np.zeros(ns_pad, np.int32)
    strip_rb[:ns] = (strip_keys // ncb).astype(np.int32)
    strip_cb[:ns] = (strip_keys % ncb).astype(np.int32)
    if len(se):
        sidx = np.searchsorted(strip_keys, skey)
        np.add.at(strips, (sidx, sr % STRIP_R, ss % tile_c), sv)

    live = np.asarray(
        [max(1, -(-nt // TILES_PER_STEP)), max(1, -(-ns // STRIPS_PER_STEP))],
        np.int32,
    )
    # the edge form: the nonzeros of the live blocks, by row then column
    t_i, t_r, t_c = np.nonzero(tiles[:nt])
    s_i, s_r, s_c = np.nonzero(strips[:ns])
    rows = np.concatenate([tile_rb[t_i].astype(np.int64) * tile_r + t_r,
                           strip_rb[s_i].astype(np.int64) * STRIP_R + s_r])
    cols = np.concatenate([tile_cb[t_i].astype(np.int64) * tile_c + t_c,
                           strip_cb[s_i].astype(np.int64) * tile_c + s_c])
    nz_vals = np.concatenate([tiles[t_i, t_r, t_c], strips[s_i, s_r, s_c]])
    order = np.lexsort((cols, rows))
    row_ptr = np.searchsorted(rows[order], np.arange(n_rows + 1))

    def dev(a: np.ndarray, dt=None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device, dtype=dt) if dt is not None else t.to(device)

    return BSRMatrix(
        tiles=dev(tiles, dtype),
        tile_rb=dev(tile_rb),
        tile_cb=dev(tile_cb),
        strips=dev(strips, dtype),
        strip_rb=dev(strip_rb),
        strip_cb=dev(strip_cb),
        live=dev(live),
        row_ptr=dev(row_ptr.astype(np.int32)),
        col=dev(cols[order].astype(np.int32)),
        # the summed f32 value, cast after the sum as the tiles are
        val=dev(nz_vals[order], dtype),
        nt=nt,
        ns=ns,
        n_rows=n_rows,
        n_cols=n_cols,
        tile_r=tile_r,
        tile_c=tile_c,
    )


def bsr_from_graph(
    graph: SparseGraph,
    tile: int = TILE,
    min_edges_per_tile: Union[int, str] = "auto",
    dtype: str = "float32",
    tile_c: int = TILE_C,
    device: DeviceLike = "cuda",
) -> BSROperator:
    """Convert a padded-COO SparseGraph into forward+transposed BSR forms.

    tile: row height of the dense tiles (column width ``tile_c``).
    min_edges_per_tile: 'auto' (the reference's cost-optimal split: densify
    iff the region holds >= AUTO_BREAKEVEN_STRIPS occupied strips) or an int
    edge-count threshold.
    dtype: 'float32' (parity mode) or 'bfloat16' (half the tile bytes; the
    kernel rounds x to bf16 and accumulates in f32).
    """
    device = resolve_device(device)
    if graph.n_nodes % tile != 0 or graph.n_nodes % tile_c != 0:
        raise ValueError(
            f"n_nodes={graph.n_nodes} must be a multiple of tile={tile} "
            f"and tile_c={tile_c}; pad the graph accordingly"
        )
    if tile % STRIP_R != 0:
        raise ValueError(f"tile={tile} must be a multiple of {STRIP_R}")
    torch_dtype = _DTYPES[dtype]
    n_edges = int(graph.n_edges)
    s = graph.senders.cpu().numpy()[:n_edges]
    r = graph.receivers.cpu().numpy()[:n_edges]
    v = graph.vals.cpu().numpy()[:n_edges]
    fwd = _build_one_direction(
        s, r, v, graph.n_nodes, tile, tile_c, min_edges_per_tile, torch_dtype, device
    )
    bwd = _build_one_direction(
        r, s, v, graph.n_nodes, tile, tile_c, min_edges_per_tile, torch_dtype, device
    )
    return BSROperator(fwd=fwd, bwd=bwd)


def attach_bsr(
    graph: SparseGraph,
    tile: int = TILE,
    min_edges_per_tile: Union[int, str] = "auto",
    dtype: str = "float32",
    device: DeviceLike = "cuda",
) -> SparseGraph:
    """The graph on ``device`` with its block-sparse form attached (built on
    the host). Always the flat form: the card has no VMEM budget to panel for."""
    device = resolve_device(device)
    op = bsr_from_graph(graph, tile, min_edges_per_tile, dtype, device=device)
    return graph.to(device).replace(bsr=op)


def streamed_elements(op: BSROperator, d: int = 128) -> dict:
    """The reference's roofline accounting: block elements its kernel
    streams per SpMM, counting live grid steps (``live``), plus the x/out
    elements. Per direction."""

    def one(m: BSRMatrix) -> dict:
        lt, ls = (int(v) for v in m.live.tolist())
        tile_elems = lt * TILES_PER_STEP * m.tile_r * m.tile_c
        strip_elems = ls * STRIPS_PER_STEP * STRIP_R * m.tile_c
        return {
            "tile_elems": tile_elems,
            "strip_elems": strip_elems,
            "block_elems": tile_elems + strip_elems,
            "x_out_elems": (m.n_cols + m.n_rows) * d,
            "elem_bytes": m.tiles.element_size(),
        }

    return {"fwd": one(op.fwd), "bwd": one(op.bwd)}


# ---------------------------------------------------------------------------
# SpMM: plain version, kernel wrapper, autograd op
# ---------------------------------------------------------------------------


def bsr_matmul_plain(m: BSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """out = A @ x in plain PyTorch: gather the x block of every live tile
    and strip, batched matmul, index_add_ into the output row blocks. The
    kernel's reference (and its version for CPU tensors)."""
    if x.dim() != 2 or x.shape[0] != m.n_cols:
        raise ValueError(f"x {tuple(x.shape)} does not match A's {m.n_cols} columns")
    d = x.shape[1]
    if m.tiles.dtype == torch.bfloat16:
        x = x.to(torch.bfloat16).float()
    xb = x.reshape(m.n_cols // m.tile_c, m.tile_c, d)
    out = torch.zeros((m.n_rows, d), dtype=torch.float32, device=x.device)
    if m.nt:
        prod = torch.bmm(m.tiles[: m.nt].float(), xb[m.tile_cb[: m.nt].long()])
        out.view(m.n_rows // m.tile_r, m.tile_r, d).index_add_(
            0, m.tile_rb[: m.nt], prod
        )
    if m.ns:
        prod = torch.bmm(m.strips[: m.ns].float(), xb[m.strip_cb[: m.ns].long()])
        out.view(m.n_rows // STRIP_R, STRIP_R, d).index_add_(
            0, m.strip_rb[: m.ns], prod
        )
    return out


_ENTRY_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("bsr_spmm")
    for fn in (lib.bsr_spmm_f32, lib.bsr_spmm_bf16):
        fn.argtypes = _ENTRY_ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check_dense(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    """A kernel's f32 dense operand: the shape given, contiguous, 16-byte
    aligned (float4 loads), on ``device``."""
    if t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned on {device}")


def _check_x(m: BSRMatrix, x: torch.Tensor) -> int:
    """The checks every kernel makes of its (n_cols, d) input; returns d."""
    if x.dim() != 2 or x.shape[0] != m.n_cols:
        raise ValueError(f"x {tuple(x.shape)} does not match A's {m.n_cols} columns")
    d = x.shape[1]
    if d == 0:
        raise ValueError("the kernels need d >= 1, got 0")
    _check_dense("x", x, (m.n_cols, d), x.device)
    return d


def _check_csr(m: BSRMatrix, x: torch.Tensor) -> int:
    """Checks for a kernel that gathers over the edge form; returns d."""
    d = _check_x(m, x)
    if m.val.dtype not in _DTYPES.values() or m.row_ptr.numel() != m.n_rows + 1:
        raise ValueError(
            f"BSRMatrix's edge form needs float32 or bfloat16 values and {m.n_rows + 1} "
            f"row pointers; got {m.val.dtype} and {m.row_ptr.numel()}"
        )
    for name in ("row_ptr", "col", "val"):
        t = getattr(m, name)
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"BSRMatrix.{name} must be contiguous on {x.device}")
    return d


def bsr_matmul(m: BSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """out = A @ x (f32 out), x (n_cols, d) for any d >= 1. A CUDA tensor goes
    through the hand-written row-gather kernel over the edge form
    (``csrc/bsr_spmm.cu``) or raises; a CPU tensor takes the plain version. Counts each kernel launch in
    ``_build.LAUNCHES['bsr_spmm']``."""
    if x.device.type == "cpu":
        return bsr_matmul_plain(m, x)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_matmul runs on cuda or cpu tensors, got {x.device}")
    d = _check_csr(m, x)
    lib = _kernel_lib()
    entry = lib.bsr_spmm_bf16 if m.val.dtype == torch.bfloat16 else lib.bsr_spmm_f32
    out = torch.empty((m.n_rows, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = entry(
            m.row_ptr.data_ptr(), m.col.data_ptr(), m.val.data_ptr(),
            x.data_ptr(), out.data_ptr(), m.n_rows, d,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, "bsr_spmm", code)
    _build.LAUNCHES["bsr_spmm"] += 1
    return out


class SpmmBSR(torch.autograd.Function):
    """A @ x over ``op.fwd``; backward A^T g over ``op.bwd`` with the same
    kernel (the reference's ``_spmm_bsr`` custom VJP). No operator gradient."""

    @staticmethod
    def forward(ctx, op: BSROperator, x: torch.Tensor) -> torch.Tensor:
        ctx.op = op
        return bsr_matmul(op.fwd, x.contiguous())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return None, bsr_matmul(ctx.op.bwd, g.contiguous())


def spmm_bsr(op: BSROperator, x: torch.Tensor) -> torch.Tensor:
    return SpmmBSR.apply(op, x)
