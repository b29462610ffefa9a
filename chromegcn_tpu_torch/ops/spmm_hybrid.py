"""Hybrid SpMM: block-sparse tiles for the dense regions, an edge list for
the stragglers (port of chromegcn_tpu/ops/spmm_hybrid.py).

The reference partitions a graph's edges once: regions of the (tile_r x
tile_c) grid that hold at least ``dense_region_edges`` edges in both A and
A^T keep its tile kernel; every other edge goes to a padded COO list sorted
by output row (``fs/fr/fv``), and its transpose sorted by sender
(``bs/br/bv``), which it multiplies with a gather and a sorted segment-sum.
It exists because the TPU kernel pays per block, and at full chromosome
scale almost every edge would need a block of its own.

Here the host arrays equal the JAX builder's, padding included, and both
parts run kernel B1 (``csrc/bsr_spmm.cu``) on the card:

- the dense part is a flat ``BSROperator`` over the dense-region edges
  (``min_edges_per_tile=1``, as the reference builds it). The reference
  panels it past its VMEM budget; the card has none, so it stays flat;
- the stragglers carry their own edge form per direction (``EdgeForm``, a
  CSR of the live entries, the padding left out): the sorted lists already
  are one, by row and then by column. Their plain version is the
  reference's arithmetic, ``index_select`` + ``index_add_`` over the padded
  lists.

A product is the two parts' sum, so it launches B1 twice and adds an (N, d)
pass. ``SpmmHybrid`` runs the backward over ``b*`` and ``dense.bwd``; the
operator gets no gradient.

``estimate_costs_ns`` is the reference's cost model, its constants the
TPU's: it is kept so its output can be held to JAX's, and ``attach_auto``
does not choose by it. ``attach_auto('auto')`` chooses by ``card_costs_ns``,
whose constants were measured on the H100 (see ``_CARD_*`` below).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from chromegcn_tpu_torch import DeviceLike, resolve_device
from chromegcn_tpu_torch.ops.sparse import SparseGraph, pad_graph
from chromegcn_tpu_torch.ops.spmm_bsr import (
    TILE, TILE_C, TILES_PER_STEP, STRIPS_PER_STEP, BSROperator, _build_one_direction,
    attach_bsr, bsr_from_graph, bsr_matmul, csr_matmul,
)

# the reference's region threshold and edge-list bucket (its arrays' shapes)
DENSE_REGION_EDGES = 96
_EDGE_BUCKET = 8192

# The reference's cost-model constants (spmm_hybrid.py:67-70): ns per tile,
# per strip and per gathered edge, and per output row, at d 128, calibrated
# on a TPU. ``estimate_costs_ns`` reads them only so that its output equals
# JAX's; they say nothing about the card.
_TILE_NS = 810.0
_STRIP_NS = 54.0
_GATHER_NS_PER_EDGE = 13.6
_OUT_WRITE_NS_PER_ROW = 128 * 4 / 60.0

# The card's cost model (``card_costs_ns``), fitted by chip_smoke.py's phase
# 17 to B1's times at d 128 on the bench and full chr1-scale graphs, per
# launch over one edge form:
#   _CARD_LAUNCH_NS + _CARD_NS_PER_LOCAL_NNZ * (nonzeros in dense regions)
#   + _CARD_NS_PER_SCATTERED_NNZ * (the other nonzeros) + _CARD_NS_PER_ROW * rows.
# A nonzero of a dense region (``_dense_selection``, the hybrid's own test)
# gathers an x row that its neighbours gather too and the caches hold; a
# straggler's is a read from device memory, ~10x the time. The add of two
# (rows, d) f32 arrays costs _CARD_ADD_NS_PER_ROW * rows. The fit is
# non-negative least squares; its free intercept would come out negative,
# which would favour the form with more launches on small graphs. It is
# within 6% at full chr1 scale and 53% high at the bench graph, whose x
# (25.7 MB) the L2 cache holds. Measured on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit.
_CARD_LAUNCH_NS = 0.0
_CARD_NS_PER_LOCAL_NNZ = 0.06508
_CARD_NS_PER_SCATTERED_NNZ = 0.72516
_CARD_NS_PER_ROW = 0.25995
_CARD_ADD_NS_PER_ROW = 0.50892


@dataclasses.dataclass
class EdgeForm:
    """One direction of the stragglers as a CSR (the form kernel B1 reads):
    row i's entries are [row_ptr[i], row_ptr[i+1]) of ``col``/``val``."""

    row_ptr: torch.Tensor  # (n_rows + 1,) int32
    col: torch.Tensor      # (nnz,) int32
    val: torch.Tensor      # (nnz,) float32
    n_rows: int
    n_cols: int

    @property
    def nnz(self) -> int:
        return self.col.numel()

    def to(self, device: DeviceLike) -> "EdgeForm":
        return dataclasses.replace(self, row_ptr=self.row_ptr.to(device),
                                   col=self.col.to(device), val=self.val.to(device))


@dataclasses.dataclass
class HybridOperator:
    """Dense-region BSR tiles + sorted straggler lists, both directions.

    ``dense`` is a flat BSROperator over only the dense-region edges (None
    when no region qualifies). ``f*`` are the forward stragglers sorted by
    receiver, ``b*`` the same edges in A^T orientation sorted by sender;
    padding entries carry val 0 and point at the last row.
    ``fwd_edges``/``bwd_edges`` are the live entries of each as a CSR."""

    dense: Optional[BSROperator]
    fs: torch.Tensor  # (E_pad,) int32 senders (gather index)
    fr: torch.Tensor  # (E_pad,) int32 receivers (segment index, sorted)
    fv: torch.Tensor  # (E_pad,) float32
    bs: torch.Tensor  # (E_pad,) int32 A^T gather index (the receivers)
    br: torch.Tensor  # (E_pad,) int32 A^T segment index (the senders, sorted)
    bv: torch.Tensor
    fwd_edges: EdgeForm
    bwd_edges: EdgeForm
    n_stragglers: int
    n_rows: int
    n_cols: int

    @property
    def n_nodes(self) -> int:
        return self.n_rows

    def to(self, device: DeviceLike) -> "HybridOperator":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None
            and not isinstance(getattr(self, f.name), int)
        })


def _sorted_coo(s: np.ndarray, r: np.ndarray, v: np.ndarray, n_rows: int,
                bucket: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort by segment index (r), then s, and pad to a bucketed capacity:
    padding points at the last row with val 0, so r stays non-decreasing."""
    order = np.lexsort((s, r))
    s, r, v = s[order], r[order], v[order]
    e = len(s)
    cap = max(bucket, int(np.ceil(max(e, 1) / bucket) * bucket))
    pad = cap - e
    s = np.concatenate([s, np.zeros(pad, np.int32)]).astype(np.int32)
    r = np.concatenate([r, np.full(pad, n_rows - 1, np.int32)]).astype(np.int32)
    v = np.concatenate([v, np.zeros(pad, np.float32)]).astype(np.float32)
    return s, r, v


def _edge_form(s: np.ndarray, r: np.ndarray, v: np.ndarray, n_live: int,
               n_rows: int, n_cols: int, device: torch.device) -> EdgeForm:
    """The live entries of one sorted list as a CSR."""
    row_ptr = np.searchsorted(r[:n_live], np.arange(n_rows + 1)).astype(np.int32)
    return EdgeForm(
        row_ptr=torch.from_numpy(row_ptr).to(device),
        col=torch.from_numpy(np.ascontiguousarray(s[:n_live])).to(device),
        val=torch.from_numpy(np.ascontiguousarray(v[:n_live])).to(device),
        n_rows=n_rows, n_cols=n_cols)


def _valid_edges(graph: SparseGraph):
    e = int(graph.n_edges)
    return (graph.senders.cpu().numpy()[:e], graph.receivers.cpu().numpy()[:e],
            graph.vals.cpu().numpy()[:e].astype(np.float32))


def _dense_selection(s: np.ndarray, r: np.ndarray, n: int, tile: int, tile_c: int,
                     dense_region_edges: int) -> np.ndarray:
    """Edges in a region that clears the threshold in both orientations (one
    partition serves A and A^T)."""
    ncb = n // tile_c

    def region_counts(rows, cols):
        key = (rows // tile).astype(np.int64) * ncb + (cols // tile_c)
        _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
        return counts[inv]

    return ((region_counts(r, s) >= dense_region_edges)
            & (region_counts(s, r) >= dense_region_edges))


def hybrid_from_graph(
    graph: SparseGraph,
    tile: int = TILE,
    tile_c: int = TILE_C,
    dense_region_edges: int = DENSE_REGION_EDGES,
    dtype: str = "float32",
    edge_bucket: int = _EDGE_BUCKET,
    device: DeviceLike = "cuda",
) -> HybridOperator:
    """Partition the edges into dense-region tiles + sorted straggler lists,
    as the reference does. The reference's ``d_model`` argument sized its
    dense part's VMEM panels; the card's dense part is always flat."""
    device = resolve_device(device)
    n = graph.n_nodes
    if n % tile != 0 or n % tile_c != 0:
        raise ValueError(
            f"n_nodes={n} must be a multiple of tile={tile} and "
            f"tile_c={tile_c}; pad the graph accordingly"
        )
    s, r, v = _valid_edges(graph)
    dense_sel = _dense_selection(s, r, n, tile, tile_c, dense_region_edges)
    dense_op = None
    if dense_sel.any():
        gtmp = pad_graph(s[dense_sel], r[dense_sel], v[dense_sel], n_valid=n, n_pad=n,
                         device="cpu")
        dense_op = bsr_from_graph(gtmp, tile=tile, tile_c=tile_c, min_edges_per_tile=1,
                                  dtype=dtype, device=device)
    ss, rr, vv = s[~dense_sel], r[~dense_sel], v[~dense_sel]
    fs, fr, fv = _sorted_coo(ss, rr, vv, n, edge_bucket)
    bs, br, bv = _sorted_coo(rr, ss, vv, n, edge_bucket)
    e = len(ss)

    def dev(a):
        return torch.from_numpy(a).to(device)

    return HybridOperator(
        dense=dense_op, fs=dev(fs), fr=dev(fr), fv=dev(fv), bs=dev(bs), br=dev(br),
        bv=dev(bv), fwd_edges=_edge_form(fs, fr, fv, e, n, n, device),
        bwd_edges=_edge_form(bs, br, bv, e, n, n, device), n_stragglers=e,
        n_rows=n, n_cols=n,
    )


def straggler_matmul_plain(gather_idx: torch.Tensor, seg_idx: torch.Tensor,
                           vals: torch.Tensor, n_rows: int, x: torch.Tensor) -> torch.Tensor:
    """The reference's straggler product (``_gather_matmul``): gather x rows,
    scale by the values, sum by segment. The kernel's reference, and its
    version for CPU tensors."""
    g = x.index_select(0, gather_idx) * vals[:, None].to(x.dtype)
    out = torch.zeros((n_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg_idx, g).float()


def straggler_matmul(op: HybridOperator, x: torch.Tensor, direction: str) -> torch.Tensor:
    """The stragglers' part of A @ x (``direction`` 'fwd') or A^T @ x
    ('bwd'): kernel B1 over their edge form for a CUDA tensor, the plain
    version for a CPU one."""
    if x.device.type == "cpu":
        if direction == "fwd":
            return straggler_matmul_plain(op.fs, op.fr, op.fv, op.n_rows, x)
        return straggler_matmul_plain(op.bs, op.br, op.bv, op.n_cols, x)
    if x.device.type != "cuda":
        raise ValueError(f"straggler_matmul runs on cuda or cpu tensors, got {x.device}")
    return csr_matmul(op.fwd_edges if direction == "fwd" else op.bwd_edges, x)


def hybrid_matmul(op: HybridOperator, x: torch.Tensor, direction: str) -> torch.Tensor:
    """A @ x or A^T @ x over both parts (the reference's ``_hybrid_apply``)."""
    y = straggler_matmul(op, x, direction)
    if op.dense is not None:
        y.add_(bsr_matmul(getattr(op.dense, direction), x))
    return y


class SpmmHybrid(torch.autograd.Function):
    """A @ x through the hybrid operator; backward A^T g over ``b*`` and
    ``dense.bwd`` (the reference's ``spmm_hybrid`` custom VJP). No operator
    gradient."""

    @staticmethod
    def forward(ctx, op: HybridOperator, x: torch.Tensor) -> torch.Tensor:
        ctx.op = op
        return hybrid_matmul(op, x.contiguous(), "fwd")

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return None, hybrid_matmul(ctx.op, g.contiguous(), "bwd")


def spmm_hybrid(op: HybridOperator, x: torch.Tensor) -> torch.Tensor:
    return SpmmHybrid.apply(op, x)


# ---------------------------------------------------------------------------
# Cost models and the choice of form
# ---------------------------------------------------------------------------


def estimate_costs_ns(graph: SparseGraph, d: int = 128, tile: int = TILE,
                      tile_c: int = TILE_C) -> dict:
    """The reference's per-SpMM estimates (ns) for its two forms, with its
    TPU constants, equal to JAX's output. Like the reference, it counts the
    forward orientation only: both its BSR count and its dense-region test
    (one orientation, where ``hybrid_from_graph`` requires both), so on an
    asymmetric graph it describes another partition than the one built."""
    s, r, v = _valid_edges(graph)
    _, _, nt, ns = _build_one_direction(
        s, r, v, graph.n_nodes, tile, tile_c, "auto", torch.float32, torch.device("cpu"),
        count_only=True,
    )
    nt_live = -(-max(nt, 1) // TILES_PER_STEP) * TILES_PER_STEP
    ns_live = -(-max(ns, 1) // STRIPS_PER_STEP) * STRIPS_PER_STEP
    bsr_ns = nt_live * _TILE_NS + ns_live * _STRIP_NS

    ncb = graph.n_nodes // tile_c
    key = (r // tile).astype(np.int64) * ncb + (s // tile_c)
    _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    dense_sel = (counts >= DENSE_REGION_EDGES)[inv]
    n_dense_tiles = int((counts >= DENSE_REGION_EDGES).sum())
    n_straggler = int((~dense_sel).sum())
    hybrid_ns = (
        n_dense_tiles * _TILE_NS
        + n_straggler * _GATHER_NS_PER_EDGE * (d / 128.0)
        + graph.n_nodes * _OUT_WRITE_NS_PER_ROW * (d / 128.0)
    )
    return {
        "bsr_ns": float(bsr_ns),
        "hybrid_ns": float(hybrid_ns),
        "n_dense_tiles": n_dense_tiles,
        "n_straggler_edges": n_straggler,
    }


def b1_cost_ns(n_local: int, n_scattered: int, n_rows: int, d: int = 128) -> float:
    """The card model's time for one B1 launch over an edge form with
    ``n_local`` dense-region and ``n_scattered`` other nonzeros."""
    return _CARD_LAUNCH_NS + (_CARD_NS_PER_LOCAL_NNZ * n_local
                              + _CARD_NS_PER_SCATTERED_NNZ * n_scattered
                              + _CARD_NS_PER_ROW * n_rows) * d / 128.0


def card_costs_ns(graph: SparseGraph, d: int = 128, tile: int = TILE, tile_c: int = TILE_C,
                  dense_region_edges: int = DENSE_REGION_EDGES) -> dict:
    """Per-SpMM estimates (ns) of the flat BSR form and the hybrid on the
    card, from the constants measured there. Both directions hold the same
    nonzeros in both forms, so one direction stands for each. The flat form
    is one B1 launch over every nonzero; the hybrid is one over the
    dense-region nonzeros, one over the stragglers (each over every row) and
    the add of the two (N, d) results. With the same per-nonzero costs on
    both sides, the hybrid costs one launch, one pass over the rows and the
    add more than the flat form whenever it has a dense part."""
    s, r, _ = _valid_edges(graph)
    n = graph.n_nodes
    n_dense = int(_dense_selection(s, r, n, tile, tile_c, dense_region_edges).sum())
    n_strag = len(s) - n_dense
    flat_ns = b1_cost_ns(n_dense, n_strag, n, d)
    hybrid_ns = b1_cost_ns(0, n_strag, n, d)
    if n_dense:
        hybrid_ns += b1_cost_ns(n_dense, 0, n, d) + _CARD_ADD_NS_PER_ROW * n * d / 128.0
    return {"bsr_ns": float(flat_ns), "hybrid_ns": float(hybrid_ns),
            "n_dense_edges": n_dense, "n_straggler_edges": n_strag}


def auto_form(graph: SparseGraph, d_model: int = 128) -> str:
    """'hybrid' if ``card_costs_ns`` finds it cheaper than the flat form,
    else 'bsr' (ties included)."""
    costs = card_costs_ns(graph, d=d_model)
    return "hybrid" if costs["hybrid_ns"] < costs["bsr_ns"] else "bsr"


def attach_auto(
    graph: SparseGraph,
    d_model: int = 128,
    dtype: str = "float32",
    strategy: str = "auto",
    device: DeviceLike = "cuda",
) -> SparseGraph:
    """The graph on ``device`` with an operator form attached: 'bsr' the flat
    BSR form, 'hybrid' the hybrid one, 'auto' whichever ``card_costs_ns``
    finds cheaper (the flat form on a tie)."""
    if strategy not in ("auto", "bsr", "hybrid"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if strategy == "auto":
        strategy = auto_form(graph, d_model)
    if strategy == "bsr":
        return attach_bsr(graph, dtype=dtype, device=device)
    device = resolve_device(device)
    op = hybrid_from_graph(graph, dtype=dtype, device=device)
    return graph.to(device).replace(bsr=op)
