"""Node-sharded SpMM: the chromosome graph cut into contiguous row shards,
each shard's edges keyed by receiver, the remote senders' rows fetched from
their owners (port of chromegcn_tpu/parallel/graph.py).

Three strategies, the reference's:
- ``all_gather``: every shard gathers the whole x, then a COO gather and
  ``index_add_`` over its edges;
- ``halo``: a boundary exchange. At partition time each shard records which
  remote rows its edges read, grouped by owner; at run time the exchange is
  S-1 ring rounds, one per shard offset k, each shipping H_k rows (the
  largest request at that offset, padded to 128). Offsets of width 0 skip
  their round on both sides. Then a gather and ``index_add_`` over the
  shard's buffer ``[x_local ; offset blocks]``;
- ``halo_bsr``: the same exchange feeding kernel B1 (``ops/spmm_bsr.py``),
  split into ``A_local @ x_local + A_halo @ halo``: the local product does
  not wait for the exchange, the halo product reads the received rows,
  zero-padded to ``halo_cols``.

The per-shard code is one, in two modes that differ only in how a ring
round moves a buffer:
- **distributed** (``group=`` a process group of S ranks, one shard per
  rank, x this rank's rows): a round is ``dist.batch_isend_irecv`` to
  ``(rank + k) % S`` and from ``(rank - k) % S``;
- **in-process** (``group=None``, all S shards in this process, x the whole
  (N, d)): a round hands a shard's tensor to another. This is the
  counterpart of the reference's single-process mesh.

The gradient is autograd's over the per-shard code: B1 over each shard's
transposed forms (``SpmmBSR``), the halo cotangent back around the ring in
reverse (``_RingExchange``), and ``index_select``'s backward adding it into
the owner's rows at ``send_maps[k-1][owner]``. Padding slots of a send map
point at row 0 and no edge reads them, so their cotangent is zero, as in
the reference.

Each ``BSRMatrix`` of a shard is built by the port's own host builder, so
it carries the edge form B1 reads; a shard's counts are its own (the
reference pads every shard to one shape for one stacked kernel; a rank's
B1 takes its own sizes). The partition arrays equal the reference's bit
for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from chromegcn_tpu_torch.ops.sparse import SparseGraph
from chromegcn_tpu_torch.ops.spmm_bsr import (
    _DTYPES, TILE, TILE_C, BSROperator, _build_one_direction, spmm_bsr,
)
from chromegcn_tpu_torch.parallel.mesh import all_gather_rows, group_rank

STRATEGIES = ("all_gather", "halo", "halo_bsr")


@dataclasses.dataclass
class ShardedBSR:
    """Per-shard block-sparse operators in halo-buffer coordinates, for the
    shards this process holds: ``local[s]`` (rows x rows, edges whose sender
    is on shard s) and ``halo[s]`` (rows x ``halo_cols``, the remote
    senders; None where shard s has none), each with its transpose."""

    local: Dict[int, BSROperator]
    halo: Dict[int, Optional[BSROperator]]
    halo_cols: int   # the halo operator's columns: sum of the H_k, padded to the tiles


@dataclasses.dataclass
class PartitionedGraph:
    """Per-shard COO, the shard on the leading axis (the reference's arrays).

    Shard s owns rows [s rows_per_shard, (s+1) rows_per_shard);
    ``senders`` are global node ids, ``receivers_local`` local row ids.
    With the halo metadata:
      send_maps:    one (S, H_k) int32 per ring offset k = 1..S-1:
                    ``send_maps[k-1][o]`` lists the local rows owner o ships
                    to (o + k) % S, padded with 0;
      halo_widths:  the H_k, each the largest request at offset k padded to
                    128 (0: the round is skipped);
      senders_halo: (S, E_s) int32, each edge's sender in the shard's buffer
                    [x_local (rows) ; offset-1 block (H_1) ; ...];
      bsr:          the per-shard block-sparse forms (``attach_shard_bsr``).
    """

    senders: torch.Tensor
    receivers_local: torch.Tensor
    vals: torch.Tensor
    node_mask: torch.Tensor
    send_maps: Tuple[torch.Tensor, ...]
    senders_halo: torch.Tensor
    n_shards: int
    rows_per_shard: int
    halo_widths: Tuple[int, ...] = ()
    bsr: Optional[ShardedBSR] = None

    @property
    def n_nodes(self) -> int:
        return self.n_shards * self.rows_per_shard

    @property
    def halo_cols(self) -> int:
        return sum(self.halo_widths)

    def replace(self, **changes) -> "PartitionedGraph":
        return dataclasses.replace(self, **changes)


def partition_graph(graph: SparseGraph, n_shards: int) -> PartitionedGraph:
    """Host-side partition of a SparseGraph into contiguous node shards
    (reference: parallel/graph.py:158-254); the arrays land on the graph's
    device."""
    if graph.n_nodes % n_shards != 0:
        raise ValueError(f"n_nodes={graph.n_nodes} not divisible by {n_shards}")
    rows = graph.n_nodes // n_shards
    n_edges = int(graph.n_edges)
    senders = graph.senders.cpu().numpy()[:n_edges]
    receivers = graph.receivers.cpu().numpy()[:n_edges]
    vals = graph.vals.cpu().numpy()[:n_edges]
    node_mask = graph.node_mask.cpu().numpy()

    shard_of = receivers // rows
    per_shard = [np.nonzero(shard_of == s)[0] for s in range(n_shards)]
    e_max = max((len(ix) for ix in per_shard), default=1)
    e_pad = int(np.ceil(max(e_max, 1) / 512) * 512)

    S = np.zeros((n_shards, e_pad), np.int32)
    R = np.zeros((n_shards, e_pad), np.int32)
    V = np.zeros((n_shards, e_pad), np.float32)
    M = np.zeros((n_shards, rows), bool)
    # needed[s][o]: sorted unique global rows shard s reads from owner o
    needed = [[None] * n_shards for _ in range(n_shards)]
    for s, ix in enumerate(per_shard):
        k = len(ix)
        S[s, :k] = senders[ix]
        R[s, :k] = receivers[ix] - s * rows
        V[s, :k] = vals[ix]
        M[s] = node_mask[s * rows:(s + 1) * rows]
        uniq = np.unique(senders[ix])
        owner = uniq // rows
        for o in range(n_shards):
            needed[s][o] = uniq[owner == o]

    # widths per ring offset k = (dest - owner) mod S, from remote requests
    # only: local senders read x_local directly
    widths = []
    for k in range(1, n_shards):
        h_k = max((len(needed[(o + k) % n_shards][o]) for o in range(n_shards)), default=0)
        widths.append(0 if h_k == 0 else int(np.ceil(h_k / 128) * 128))
    base = rows + np.concatenate([[0], np.cumsum(widths)]).astype(np.int64)

    send_maps = [np.zeros((n_shards, w), np.int32) for w in widths]
    senders_halo = np.zeros((n_shards, e_pad), np.int32)
    for k in range(1, n_shards):
        for o in range(n_shards):
            req = needed[(o + k) % n_shards][o]
            send_maps[k - 1][o, :len(req)] = req - o * rows
    for s in range(n_shards):
        # a local sender g sits at g - s rows, a remote one from owner o at
        # base[k-1] + its rank in needed[s][o], k = (s - o) mod S
        ke = len(per_shard[s])
        es = senders[per_shard[s]]
        owner = es // rows
        pos = np.zeros(ke, np.int64)
        local = owner == s
        pos[local] = es[local] - s * rows
        for o in range(n_shards):
            if o == s:
                continue
            sel = owner == o
            if sel.any():
                k = (s - o) % n_shards
                pos[sel] = base[k - 1] + np.searchsorted(needed[s][o], es[sel])
        senders_halo[s, :ke] = pos

    device = graph.device

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return PartitionedGraph(
        senders=dev(S), receivers_local=dev(R), vals=dev(V), node_mask=dev(M),
        send_maps=tuple(dev(a) for a in send_maps), senders_halo=dev(senders_halo),
        n_shards=n_shards, rows_per_shard=rows, halo_widths=tuple(widths),
    )


def attach_shard_bsr(
    pg: PartitionedGraph,
    dtype: str = "float32",
    shards: Optional[Sequence[int]] = None,
) -> PartitionedGraph:
    """Build the per-shard local and halo operators at the flat form's tiles
    (reference: parallel/graph.py:257-413), on the partition's device, for
    ``shards`` (default: all, as the in-process mode needs; a rank passes
    its own, and materialises no other shard's blocks). Each direction is
    split on sender locality: column < rows is local, the rest is the halo
    in buffer coordinates."""
    rows = pg.rows_per_shard
    halo_cols = pg.halo_cols
    if rows % TILE or rows % TILE_C or halo_cols % TILE_C:
        raise ValueError(
            f"rows_per_shard={rows} and halo block={halo_cols} must be "
            f"multiples of tile={TILE} and tile_c={TILE_C}")
    # the halo columns padded to max(tile, tile_c), so the transposed
    # operator's rows block evenly (the reference's :355, :408)
    pad = max(TILE, TILE_C)
    hc_pad = -(-halo_cols // pad) * pad
    shards = range(pg.n_shards) if shards is None else shards

    def build(src, dst, val, n_rows, n_cols):
        return _build_one_direction(src, dst, val, n_rows=n_rows, tile_r=TILE, tile_c=TILE_C,
                                    min_edges_per_tile="auto", dtype=_DTYPES[dtype],
                                    device=pg.vals.device, n_cols=n_cols)

    local, halo = {}, {}
    for s in shards:
        vals = pg.vals[s].cpu().numpy()
        live = vals != 0.0  # padding edges carry val 0
        c = pg.senders_halo[s].cpu().numpy()[live]
        r = pg.receivers_local[s].cpu().numpy()[live]
        v = vals[live]
        loc = c < rows
        local[s] = BSROperator(fwd=build(c[loc], r[loc], v[loc], rows, rows),
                               bwd=build(r[loc], c[loc], v[loc], rows, rows))
        ch, rh, vh = c[~loc] - rows, r[~loc], v[~loc]
        halo[s] = None if not len(ch) else BSROperator(
            fwd=build(ch, rh, vh, rows, hc_pad), bwd=build(rh, ch, vh, hc_pad, rows))
    return pg.replace(bsr=ShardedBSR(local=local, halo=halo, halo_cols=hc_pad))


# ---------------------------------------------------------------------------
# The sharded product
# ---------------------------------------------------------------------------


def _send_recv(buf: torch.Tensor, k: int, group) -> torch.Tensor:
    """Send ``buf`` to rank (r + k) % S and receive the same shape from
    (r - k) % S, over ``group``."""
    rank, world = group_rank(group)
    out = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf.contiguous(),
                      dist.get_global_rank(group, (rank + k) % world), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (rank - k) % world), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingExchange(torch.autograd.Function):
    """One ring round at offset k; the backward sends each cotangent back
    to the buffer's owner (offset -k)."""

    @staticmethod
    def forward(ctx, buf, k, group):
        ctx.k, ctx.group = k, group
        return _send_recv(buf, k, group)

    @staticmethod
    def backward(ctx, g):
        return _send_recv(g, -ctx.k, ctx.group), None, None


def _ring_round(bufs: Dict[int, torch.Tensor], k: int, n_shards: int, group
                ) -> Dict[int, torch.Tensor]:
    """Shard s receives owner (s - k) % S's buffer: a tensor handed between
    shards in-process, a send/recv pair between ranks."""
    if group is None:
        return {s: bufs[(s - k) % n_shards] for s in bufs}
    (s, buf), = bufs.items()
    return {s: _RingExchange.apply(buf, k, group)}


def _exchange(pg: PartitionedGraph, xs: Dict[int, torch.Tensor], group
              ) -> Dict[int, list]:
    """Each held shard's received halo blocks, in offset order; offsets of
    width 0 skip their round."""
    recv = {s: [] for s in xs}
    for k, (sm, width) in enumerate(zip(pg.send_maps, pg.halo_widths), start=1):
        if width == 0:
            continue
        bufs = {s: x.index_select(0, sm[s]) for s, x in xs.items()}  # (H_k, d)
        for s, r in _ring_round(bufs, k, pg.n_shards, group).items():
            recv[s].append(r)
    return recv


def _gather_sum(buf, idx, vals, receivers, rows):
    """out[i] = sum of vals[e] buf[idx[e]] over edges e with receivers[e] == i."""
    weighted = buf.index_select(0, idx) * vals[:, None].to(buf.dtype)
    out = torch.zeros((rows,) + buf.shape[1:], dtype=buf.dtype, device=buf.device)
    return out.index_add_(0, receivers, weighted)


def sharded_spmm(pg: PartitionedGraph, x: torch.Tensor, group=None,
                 strategy: str = "halo") -> torch.Tensor:
    """A @ x over the partition (reference: parallel/graph.py:416-561).

    ``group=None``: x is the whole (N, d), every shard runs here, and the
    result is (N, d). A process group of S ranks: x is this rank's
    (rows_per_shard, d) and so is the result."""
    S, rows = pg.n_shards, pg.rows_per_shard
    if group is None:
        if x.shape[0] != pg.n_nodes:
            raise ValueError(f"x has {x.shape[0]} rows, the partition {pg.n_nodes}")
        xs = dict(enumerate(x.split(rows)))
    else:
        rank, world = group_rank(group)
        if world != S:
            raise ValueError(f"the partition has {S} shards and the group {world} ranks")
        if x.shape[0] != rows:
            raise ValueError(f"x has {x.shape[0]} rows, a shard {rows}")
        xs = {rank: x}

    if strategy == "all_gather":
        full = x if group is None else all_gather_rows(x, group)
        outs = {s: _gather_sum(full, pg.senders[s], pg.vals[s], pg.receivers_local[s], rows)
                for s in xs}
    elif strategy == "halo":
        recv = _exchange(pg, xs, group)
        outs = {s: _gather_sum(torch.cat([xs[s], *recv[s]]), pg.senders_halo[s], pg.vals[s],
                               pg.receivers_local[s], rows)
                for s in xs}
    elif strategy == "halo_bsr":
        sb = pg.bsr
        if sb is None:
            raise ValueError(
                "strategy='halo_bsr' needs per-shard block-sparse forms; attach them "
                "with parallel.graph.attach_shard_bsr(pg)")
        missing = [s for s in xs if s not in sb.local]
        if missing:
            raise ValueError(f"shards {missing} have no block-sparse form here")
        # the local products first: they do not wait for the exchange
        outs = {s: spmm_bsr(sb.local[s], x_s) for s, x_s in xs.items()}
        recv = _exchange(pg, xs, group)
        for s in xs:
            if not recv[s]:
                continue
            halo = torch.cat(recv[s])
            if sb.halo[s] is None:
                # no edge of this shard reads a remote row, yet it received
                # blocks (a round runs where any shard needs it); between
                # ranks its backward must still send their zero cotangents
                # back around the ring, or the owners wait for them. An
                # exact 0 keeps them in the graph.
                if group is not None:
                    outs[s] = outs[s] + halo[:0].sum()
                continue
            # the operator's columns are padded to the tiles; no edge reads
            # the pad rows
            halo = F.pad(halo, (0, 0, 0, sb.halo_cols - halo.shape[0]))
            outs[s] = outs[s] + spmm_bsr(sb.halo[s], halo)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    if group is None:
        return torch.cat([outs[s] for s in range(S)])
    return outs[rank]


@dataclasses.dataclass
class ShardedGraph:
    """Node-sharded stand-in for a SparseGraph in the chrome models: the
    ``ops.spmm`` dispatch routes it to ``sharded_spmm``.

    In-process (``group=None``) the model sees whole tensors and
    ``node_mask`` is the (N,) mask; only the operator is sharded. With a
    process group, tensors are this rank's rows, ``node_mask`` is their
    mask, and the masked BatchNorm, the loss and the steps' gradients reduce
    over ``group``."""

    pg: PartitionedGraph
    node_mask: torch.Tensor
    strategy: str = "halo"
    n_nodes: int = 0
    group: Optional[dist.ProcessGroup] = None

    @property
    def bsr(self) -> Optional[ShardedBSR]:
        """The per-shard forms: no operator the fused kernels take
        (``ops.gcn_fused.fused_fits`` is False), so ``-gcn_fused on`` runs the
        unfused layer when sharded, as in the reference."""
        return self.pg.bsr

    @property
    def device(self) -> torch.device:
        return self.node_mask.device


def shard_graph(
    graph: SparseGraph,
    n_shards: int,
    strategy: str = "auto",
    spmm_dtype: str = "float32",
    group=None,
) -> ShardedGraph:
    """Partition a chromosome graph into ``n_shards`` (reference:
    parallel/graph.py:589-618). With ``group`` (a process group of
    ``n_shards`` ranks) this rank builds only its own shard's block-sparse
    forms and keeps its rows of the mask.

    strategy: 'auto' picks 'halo_bsr' when the graph carries an operator
    form, else 'halo'; or 'halo' | 'halo_bsr' | 'all_gather'."""
    if strategy == "auto":
        strategy = "halo_bsr" if graph.bsr is not None else "halo"
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    rank, world = group_rank(group)
    if group is not None and world != n_shards:
        raise ValueError(f"{n_shards} shards over a group of {world} ranks")
    pg = partition_graph(graph, n_shards)
    if strategy == "halo_bsr":
        pg = attach_shard_bsr(pg, dtype=spmm_dtype,
                              shards=None if group is None else [rank])
    mask = graph.node_mask
    if group is not None:
        mask = pg.node_mask[rank]
    return ShardedGraph(pg=pg, node_mask=mask, strategy=strategy,
                        n_nodes=graph.n_nodes, group=group)


def sharded_graph_spmm(graph: ShardedGraph, x: torch.Tensor) -> torch.Tensor:
    """The ``ops.spmm`` entry for a ShardedGraph."""
    return sharded_spmm(graph.pg, x, group=graph.group, strategy=graph.strategy)
