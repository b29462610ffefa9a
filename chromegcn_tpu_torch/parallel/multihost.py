"""Row placement across ranks (port of chromegcn_tpu/parallel/multihost.py).

Under JAX a process builds a global array from its own rows
(``jax.make_array_from_process_local_data``). Under ``torch.distributed``
each rank holds its rows as an ordinary tensor, so placement is choosing
them: every rank derives its rows from the same (rows, rank, world) triple,
with no traffic, and loading stays deterministic.

Contracts, as the reference's:
- a row-sharded array is cut into equal shards, shard i rank i's. A rank is
  one device here, so its rows are one contiguous range by construction:
  the reference's check for a process whose devices hold scattered shards
  has no counterpart;
- ``put_global`` is the one entry point: with one rank it returns the whole
  array, so the trainers' code is the same on one rank and on many.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def local_row_range(n_rows: int, rank: int, world: int) -> Tuple[int, int]:
    """Contiguous [start, stop) of the leading-axis rows ``rank`` owns: the
    rows cut into ``world`` equal shards, in rank order. Raises if the rows
    do not cut evenly or if the rank is not one of ``world``."""
    if n_rows % world:
        raise ValueError(f"{n_rows} rows do not cut into {world} equal shards")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} owns no shard of the rows: the world has {world} ranks")
    per = n_rows // world
    return rank * per, (rank + 1) * per


def put_global(arr, rank: int, world: int, *, already_local: bool = False):
    """This rank's rows of a row-sharded array.

    One rank: ``arr`` as it is. More: ``arr`` is either the whole array
    (each rank takes its own rows, as when every rank loads the same file)
    or, with ``already_local=True``, this rank's rows already, returned as
    they are once the rank is checked against the global extent, its rows
    times the rank count."""
    if world == 1:
        return arr
    if already_local:
        local_row_range(np.shape(arr)[0] * world, rank, world)
        return arr
    lo, hi = local_row_range(np.shape(arr)[0], rank, world)
    return arr[lo:hi]


def host_batch_slice(batch_size: int, rank: int, world: int) -> Tuple[int, int]:
    """The contiguous [start, stop) of every global batch this rank feeds in
    data-parallel pretraining."""
    return local_row_range(batch_size, rank, world)
