"""Ingest-time node reordering (port of chromegcn_tpu/ops/reorder.py).

The BSR kernel's streamed-element count (its HBM cost) is set by how many
128-wide blocks the edge set touches; a node order that concentrates edges
near the diagonal needs fewer blocks. This module provides the standard
bandwidth-minimizing orders plus the accounting to decide whether to apply
one.

The reference found genomic coordinate order already near-optimal for
Hi-C graphs (contact probability decays with genomic distance, so the
contact graph is banded, and RCM scrambles the band's local block
structure), and does not reorder them; the orders are for graph flavours
whose node order is arbitrary (expression/eQTL contact maps). On the card,
kernel B1 gathers x rows through the caches, so the same band keeps
neighbouring rows' gathers local; no reordering was measured there.

Permutation convention: ``order`` is "new position -> old node id"
(scipy's RCM convention), so features move with ``x[order]`` and outputs
move back with ``y = y_new[inverse(order)]``. Padded tail nodes
[n_valid, n_nodes) are never moved, and node_mask is preserved.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

import torch

from chromegcn_tpu_torch.ops.sparse import SparseGraph


def _valid_edges(graph: SparseGraph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    n_edges = int(graph.n_edges)
    return (
        graph.senders.cpu().numpy()[:n_edges],
        graph.receivers.cpu().numpy()[:n_edges],
        graph.vals.cpu().numpy()[:n_edges],
    )


def _n_valid(graph: SparseGraph) -> int:
    return graph.n_valid_nodes


def _extend_identity(order_valid: np.ndarray, n_nodes: int) -> np.ndarray:
    """Extend a permutation of the valid nodes with an identity padded tail."""
    n_valid = order_valid.shape[0]
    order = np.arange(n_nodes, dtype=np.int32)
    order[:n_valid] = order_valid.astype(np.int32)
    return order


def rcm_permutation(graph: SparseGraph) -> np.ndarray:
    """Reverse Cuthill–McKee order of the valid subgraph (bandwidth
    minimizer). new->old; identity on the padded tail."""
    from scipy import sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n_valid = _n_valid(graph)
    s, r, v = _valid_edges(graph)
    a = sp.csr_matrix(
        (np.ones_like(v), (r.astype(np.int64), s.astype(np.int64))),
        shape=(n_valid, n_valid),
    )
    order_valid = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=False))
    return _extend_identity(order_valid, graph.n_nodes)


def degree_sort_permutation(graph: SparseGraph) -> np.ndarray:
    """Valid nodes by descending degree (stable). new->old; identity tail."""
    n_valid = _n_valid(graph)
    s, r, _ = _valid_edges(graph)
    deg = np.bincount(r, minlength=n_valid) + np.bincount(s, minlength=n_valid)
    order_valid = np.argsort(-deg[:n_valid], kind="stable")
    return _extend_identity(order_valid, graph.n_nodes)


def inverse_permutation(order: np.ndarray) -> np.ndarray:
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0], dtype=order.dtype)
    return inv


def permute_graph(graph: SparseGraph, order: np.ndarray) -> SparseGraph:
    """Relabel nodes: node old -> position of old in ``order``.

    Returns a new SparseGraph (bsr detached — re-attach after reordering).
    With x_new = x[order], spmm(perm_graph, x_new) == spmm(graph, x)[order].
    """
    order = np.asarray(order)
    if order.shape[0] != graph.n_nodes:
        raise ValueError(
            f"order covers {order.shape[0]} nodes, graph has {graph.n_nodes}"
        )
    n_valid = _n_valid(graph)
    if not np.array_equal(
        np.sort(order[:n_valid]), np.arange(n_valid)
    ) or not np.array_equal(order[n_valid:], np.arange(n_valid, graph.n_nodes)):
        raise ValueError(
            "order must permute the valid nodes and be identity on the padded tail"
        )
    inv = torch.as_tensor(inverse_permutation(order.astype(np.int32)), device=graph.device)
    return graph.replace(
        senders=inv[graph.senders.long()],
        receivers=inv[graph.receivers.long()],
        bsr=None,
    )


def streamed_block_elements(graph: SparseGraph, **bsr_kwargs) -> int:
    """Forward-direction live block elements the reference's BSR kernel
    would stream for this graph (``ops.spmm_bsr.streamed_elements``), the
    objective a reordering tries to minimize. Built on the host."""
    from chromegcn_tpu_torch.ops import spmm_bsr

    op = spmm_bsr.bsr_from_graph(graph, device="cpu", **bsr_kwargs)
    return spmm_bsr.streamed_elements(op)["fwd"]["block_elems"]
