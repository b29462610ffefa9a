"""SpMM (sparse adjacency x dense features), the hot op of the GCN stage
(port of chromegcn_tpu/ops/spmm.py).

``impl`` takes the reference's strings, so a config carries over:

- ``'xla'``    -> ``spmm_coo``: the plain COO path, an ``index_select`` of
  x rows by sender, scaled by the edge values, ``index_add_`` by receiver
  (the reference's gather + segment-sum). Autograd derives its backward.
- ``'pallas'`` -> ``spmm_bsr``: the hand-written block-sparse CUDA kernel
  over the graph's attached BSR form (``ops.spmm_bsr.attach_bsr``), with
  the transposed tiling for the backward pass.
- ``'auto'``   -> ``'pallas'`` when the graph carries a BSR form, else ``'xla'``.
"""

from __future__ import annotations

import torch

from chromegcn_tpu_torch.ops.sparse import SparseGraph
from chromegcn_tpu_torch.ops.spmm_bsr import spmm_bsr


def spmm_coo(graph: SparseGraph, x: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_e vals[e] * x[senders[e]], grouped by receivers[e].

    Padding edges have val == 0 and indices 0, so they contribute nothing.
    """
    weighted = x.index_select(0, graph.senders) * graph.vals[:, None].to(x.dtype)
    out = torch.zeros((graph.n_nodes,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add_(0, graph.receivers, weighted)


def spmm(graph: SparseGraph, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Sparse-matrix x dense-matrix product over a SparseGraph; ``impl`` as
    in the module docstring."""
    if impl == "auto":
        impl = "pallas" if graph.bsr is not None else "xla"
    if impl == "xla":
        return spmm_coo(graph, x)
    if impl == "pallas":
        if graph.bsr is None:
            raise ValueError(
                "impl='pallas' requires a precomputed block-sparse form; "
                "attach one with ops.spmm_bsr.attach_bsr(graph)"
            )
        return spmm_bsr(graph.bsr, x)
    raise ValueError(f"unknown spmm impl {impl!r}")
