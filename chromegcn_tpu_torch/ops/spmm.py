"""SpMM (sparse adjacency x dense features), the hot op of the GCN stage
(port of chromegcn_tpu/ops/spmm.py).

``impl`` takes the reference's strings, so a config carries over:

- ``'xla'``    -> ``spmm_coo``: the plain COO path, an ``index_select`` of
  x rows by sender, scaled by the edge values, ``index_add_`` by receiver
  (the reference's gather + segment-sum). Autograd derives its backward.
- ``'pallas'`` -> ``spmm_operator``: the hand-written CUDA kernel B1 over
  the operator form attached to the graph, with its transposed form for
  the backward pass: the flat ``BSROperator`` (``ops.spmm_bsr.attach_bsr``),
  the ``BSRPanelOperator`` (``bsr_panels_from_graph``) or the
  ``HybridOperator`` (``ops.spmm_hybrid.attach_auto``), as the reference's
  ``spmm_pallas`` dispatches them.
- ``'auto'``   -> ``'pallas'`` when the graph carries an operator form, else ``'xla'``.

A node-sharded ``parallel.graph.ShardedGraph`` goes to ``sharded_spmm``
whatever ``impl`` says: its strategy already names the per-shard product
(B1 over each shard's forms, or a gather and ``index_add_``), as the
reference's dispatch does (ops/spmm.py:86-91).

``sddmm`` is the gradient of the product with respect to the edge values,
for adjacency saliency (analysis/saliency.py).
"""

from __future__ import annotations

import torch

from chromegcn_tpu_torch.ops.sparse import SparseGraph
from chromegcn_tpu_torch.ops.spmm_bsr import (
    BSROperator, BSRPanelOperator, spmm_bsr, spmm_bsr_panels,
)
from chromegcn_tpu_torch.ops.spmm_hybrid import HybridOperator, spmm_hybrid
from chromegcn_tpu_torch.parallel.graph import ShardedGraph, sharded_graph_spmm


def spmm_coo(graph: SparseGraph, x: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_e vals[e] * x[senders[e]], grouped by receivers[e].

    Padding edges have val == 0 and indices 0, so they contribute nothing.
    """
    weighted = x.index_select(0, graph.senders) * graph.vals[:, None].to(x.dtype)
    out = torch.zeros((graph.n_nodes,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add_(0, graph.receivers, weighted)


def sddmm(graph: SparseGraph, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense product: out[e] = <a[receivers[e]], b[senders[e]]>,
    the gradient of ``spmm`` with respect to the edge values (reference:
    chromegcn_tpu/ops/spmm.py:52)."""
    return (a.index_select(0, graph.receivers) * b.index_select(0, graph.senders)).sum(-1)


def spmm_operator(op, x: torch.Tensor) -> torch.Tensor:
    """A @ x through an attached operator form, whichever it is."""
    if isinstance(op, BSROperator):
        return spmm_bsr(op, x)
    if isinstance(op, BSRPanelOperator):
        return spmm_bsr_panels(op, x)
    if isinstance(op, HybridOperator):
        return spmm_hybrid(op, x)
    raise TypeError(f"unsupported operator type {type(op)}")


def spmm(graph: SparseGraph, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Sparse-matrix x dense-matrix product over a SparseGraph; ``impl`` as
    in the module docstring."""
    if isinstance(graph, ShardedGraph):
        return sharded_graph_spmm(graph, x)
    if impl == "auto":
        impl = "pallas" if graph.bsr is not None else "xla"
    if impl == "xla":
        return spmm_coo(graph, x)
    if impl == "pallas":
        if graph.bsr is None:
            raise ValueError(
                "impl='pallas' requires a precomputed operator form; attach one "
                "with ops.spmm_bsr.attach_bsr or ops.spmm_hybrid.attach_auto"
            )
        return spmm_operator(graph.bsr, x)
    raise ValueError(f"unknown spmm impl {impl!r}")
