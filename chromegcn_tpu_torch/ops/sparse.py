"""Sparse chromosome-graph container and graph construction (port of
chromegcn_tpu/ops/sparse.py).

A chromosome graph is a padded COO: ``senders``/``receivers``/``vals`` of a
fixed (bucketed) edge capacity over a fixed (bucketed) node capacity.
Padding edges carry ``val == 0`` and point at node 0, so they are no-ops
under segment-sum aggregation; padding nodes are excluded from losses and
BatchNorm statistics via ``node_mask``.

The host (numpy) construction is kept exactly as in the reference, so the
edge arrays come out equal, not just close. The adjacency flavours mirror
the reference's ``process_graph`` (reference: utils/util_methods.py:146-180):

- ``constant``: banded +/-7 neighbours plus self loops
- ``hic``:      Hi-C top-k contact pairs, self loops added, then binarized
- ``both``:     Hi-C + band + self loops, *not* binarized (raw values add)
- ``none``:     identity

followed by row normalization D^-1 A with a zero-degree guard.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from chromegcn_tpu_torch import DeviceLike, resolve_device


@dataclasses.dataclass
class SparseGraph:
    """Padded COO sparse adjacency over one chromosome's windows.

    out[i] = sum_e vals[e] * x[senders[e]] for receivers[e] == i.

    Attributes:
      senders:   (E_pad,) int32 — source node (column) index per edge.
      receivers: (E_pad,) int32 — destination node (row) index per edge.
      vals:      (E_pad,) float32 — edge weights; 0.0 for padding edges.
      n_edges:   number of valid (non-padding) edges.
      node_mask: (n_nodes,) bool — True for valid (non-padding) nodes.
      n_nodes:   padded node capacity.
      bsr:       optional block-sparse form (ops.spmm_bsr.BSROperator),
                 attached with ops.spmm_bsr.attach_bsr.
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    vals: torch.Tensor
    n_edges: int
    node_mask: torch.Tensor
    n_nodes: int
    bsr: Optional[object] = None

    @property
    def edge_capacity(self) -> int:
        return int(self.senders.shape[0])

    @property
    def n_valid_nodes(self) -> int:
        return int(self.node_mask.sum())

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def replace(self, **changes) -> "SparseGraph":
        return dataclasses.replace(self, **changes)

    def transpose(self) -> "SparseGraph":
        """A^T: swap senders/receivers."""
        return self.replace(senders=self.receivers, receivers=self.senders)

    def to(self, device: DeviceLike) -> "SparseGraph":
        return self.replace(
            senders=self.senders.to(device),
            receivers=self.receivers.to(device),
            vals=self.vals.to(device),
            node_mask=self.node_mask.to(device),
            bsr=None if self.bsr is None else self.bsr.to(device),
        )


# ---------------------------------------------------------------------------
# Host-side (numpy) construction
# ---------------------------------------------------------------------------


def _as_int32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int32)


def coalesce_coo(
    senders: np.ndarray, receivers: np.ndarray, vals: np.ndarray, n_nodes: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sum duplicate (receiver, sender) entries, sorted row-major (scipy
    sparse-matrix addition semantics, so edge-list sums reproduce
    ``A + eye`` / ``A + band`` exactly)."""
    senders = _as_int32(senders)
    receivers = _as_int32(receivers)
    vals = np.asarray(vals, dtype=np.float32)
    key = receivers.astype(np.int64) * n_nodes + senders.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    out_vals = np.zeros(uniq.shape[0], dtype=np.float32)
    np.add.at(out_vals, inv, vals)
    out_receivers = (uniq // n_nodes).astype(np.int32)
    out_senders = (uniq % n_nodes).astype(np.int32)
    return out_senders, out_receivers, out_vals


def band_edges(n_valid: int, band: int = 7) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Constant-diagonal graph: neighbours at offsets -band..band excluding 0
    (reference: utils/util_methods.py:137-144)."""
    senders, receivers = [], []
    for off in range(-band, band + 1):
        if off == 0:
            continue
        i = np.arange(max(0, -off), min(n_valid, n_valid - off), dtype=np.int32)
        receivers.append(i)
        senders.append(i + off)
    s = np.concatenate(senders)
    r = np.concatenate(receivers)
    return s, r, np.ones(s.shape[0], dtype=np.float32)


def eye_edges(n_valid: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    i = np.arange(n_valid, dtype=np.int32)
    return i, i, np.ones(n_valid, dtype=np.float32)


def build_chrom_graph(
    adj_type: str,
    n_valid: int,
    n_pad: Optional[int] = None,
    edge_capacity: Optional[int] = None,
    hic_edges: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    band: int = 7,
    row_normalize_values: bool = True,
    device: DeviceLike = "cuda",
) -> SparseGraph:
    """Build one chromosome's adjacency in the reference's four flavours,
    D^-1 A row-normalized, as a padded SparseGraph on ``device``.

    Args:
      adj_type: one of 'constant' | 'hic' | 'both' | 'none'.
      n_valid: number of real windows (nodes) on this chromosome.
      n_pad: padded node capacity (defaults to n_valid rounded up to 128).
      edge_capacity: padded edge capacity (defaults to next multiple of 1024).
      hic_edges: (senders, receivers, vals) numpy COO of Hi-C contacts.
      band: constant-graph half-width.
    """
    device = resolve_device(device)
    if n_pad is None:
        n_pad = int(np.ceil(max(n_valid, 1) / 128) * 128)
    if n_pad < n_valid:
        raise ValueError(f"n_pad={n_pad} < n_valid={n_valid}")

    if adj_type == "constant":
        parts = [band_edges(n_valid, band), eye_edges(n_valid)]
        binarize = False
    elif adj_type == "hic":
        if hic_edges is None:
            raise ValueError("adj_type='hic' requires hic_edges")
        parts = [hic_edges, eye_edges(n_valid)]
        binarize = True  # reference: utils/util_methods.py:163-164
    elif adj_type == "both":
        if hic_edges is None:
            raise ValueError("adj_type='both' requires hic_edges")
        parts = [hic_edges, band_edges(n_valid, band), eye_edges(n_valid)]
        binarize = False  # reference 'both' branch does not binarize
    elif adj_type == "none":
        parts = [eye_edges(n_valid)]
        binarize = False
    else:
        raise ValueError(f"unknown adj_type {adj_type!r}")

    s = np.concatenate([p[0] for p in parts]).astype(np.int32)
    r = np.concatenate([p[1] for p in parts]).astype(np.int32)
    v = np.concatenate([p[2] for p in parts]).astype(np.float32)
    s, r, v = coalesce_coo(s, r, v, n_pad)

    if binarize:
        v = np.where(v > 0, 1.0, 0.0).astype(np.float32)

    if row_normalize_values:
        deg = np.zeros(n_pad, dtype=np.float64)
        np.add.at(deg, r, v.astype(np.float64))
        inv = np.where(deg == 0.0, 0.0, 1.0 / np.where(deg == 0.0, 1.0, deg))
        v = (v * inv[r]).astype(np.float32)

    return pad_graph(
        s, r, v, n_valid=n_valid, n_pad=n_pad, edge_capacity=edge_capacity,
        device=device,
    )


def pad_graph(
    senders: np.ndarray,
    receivers: np.ndarray,
    vals: np.ndarray,
    n_valid: int,
    n_pad: int,
    edge_capacity: Optional[int] = None,
    device: DeviceLike = "cuda",
) -> SparseGraph:
    """Pad COO arrays to a static edge capacity and build the graph."""
    device = resolve_device(device)
    e = int(senders.shape[0])
    if edge_capacity is None:
        edge_capacity = int(np.ceil(max(e, 1) / 1024) * 1024)
    if edge_capacity < e:
        raise ValueError(f"edge_capacity={edge_capacity} < n_edges={e}")
    pad = edge_capacity - e
    s = np.concatenate([senders, np.zeros(pad, np.int32)]).astype(np.int32)
    r = np.concatenate([receivers, np.zeros(pad, np.int32)]).astype(np.int32)
    v = np.concatenate([vals, np.zeros(pad, np.float32)]).astype(np.float32)
    mask = np.zeros(n_pad, dtype=bool)
    mask[:n_valid] = True
    return SparseGraph(
        senders=torch.from_numpy(s).to(device),
        receivers=torch.from_numpy(r).to(device),
        vals=torch.from_numpy(v).to(device),
        n_edges=e,
        node_mask=torch.from_numpy(mask).to(device),
        n_nodes=int(n_pad),
    )


# ---------------------------------------------------------------------------
# Device-side ops
# ---------------------------------------------------------------------------


def row_normalize(graph: SparseGraph) -> SparseGraph:
    """D^-1 A with a zero-degree guard: rows with zero sum stay all-zero
    (reference: utils/util_methods.py:99-106)."""
    deg = torch.zeros(graph.n_nodes, dtype=graph.vals.dtype, device=graph.device)
    deg.index_add_(0, graph.receivers, graph.vals)
    inv = torch.where(deg == 0.0, 0.0, 1.0 / torch.where(deg == 0.0, 1.0, deg))
    return graph.replace(vals=graph.vals * inv[graph.receivers])


def binarize(graph: SparseGraph) -> SparseGraph:
    """Positive weights to 1, the rest to 0, per stored edge
    (utils/util_methods.py:163-164)."""
    return graph.replace(vals=(graph.vals > 0).to(graph.vals.dtype))


def to_dense(graph: SparseGraph) -> torch.Tensor:
    """Densify (tests / tiny graphs only)."""
    dense = torch.zeros(
        (graph.n_nodes, graph.n_nodes), dtype=graph.vals.dtype, device=graph.device
    )
    return dense.index_put_(
        (graph.receivers.long(), graph.senders.long()), graph.vals, accumulate=True
    )


def from_dense(
    dense: np.ndarray, n_valid: Optional[int] = None, device: DeviceLike = "cuda"
) -> SparseGraph:
    """Build a SparseGraph from a dense matrix (tests only)."""
    dense = np.asarray(dense, dtype=np.float32)
    n = dense.shape[0]
    r, s = np.nonzero(dense)
    v = dense[r, s]
    return pad_graph(
        s.astype(np.int32),
        r.astype(np.int32),
        v,
        n_valid=n if n_valid is None else n_valid,
        n_pad=n,
        device=device,
    )
