"""The port's parallel paths (chromegcn_tpu_torch/parallel) in one process,
against the JAX package's on the CPU: the partition's arrays equal JAX's bit
for bit, the per-shard block-sparse forms hold JAX's blocks, and the
in-process sharded product (``group=None``, every shard here) matches JAX's
product, forward and gradient, for 1, 2, 4 and 8 shards and all three
strategies. The JAX side is its one-device product, which its own sharded
one equals (tests/test_partition.py): a JAX ``sharded_spmm`` over the
conftest's virtual devices costs 5 s a call, 30 s with its Pallas kernel
interpreted. Then the joint steps on an in-process sharded graph against
JAX's, the row placement (tests/test_multihost.py's layouts) and the
meshes. The runs
across processes are in tests/test_torch_parallel_ranks.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from chromegcn_tpu.ops import sparse as jsp
from chromegcn_tpu.ops.spmm import spmm_xla
from chromegcn_tpu.parallel import graph as jgraph
from chromegcn_tpu.train import joint as jjoint
from chromegcn_tpu_torch.data.constants import SRC_VOCAB
from chromegcn_tpu_torch.data.synthetic import make_hic_edges
from chromegcn_tpu_torch.models.chrome import ChromeGCN
from chromegcn_tpu_torch.ops import sparse as tsp
from chromegcn_tpu_torch.ops.gcn_fused import fused_fits
from chromegcn_tpu_torch.ops.seq import complement_permutation
from chromegcn_tpu_torch.ops.spmm import spmm, spmm_coo
from chromegcn_tpu_torch.parallel import mesh as tmesh
from chromegcn_tpu_torch.parallel import multihost
from chromegcn_tpu_torch.parallel.graph import (
    ShardedGraph, attach_shard_bsr, partition_graph, shard_graph, sharded_spmm,
)
from chromegcn_tpu_torch.utils.convert import chromegcn_state_dict, window_state_dict
from test_torch_joint import _states as joint_states
from test_torch_rnn import one_thread
import torch_parallel_workers as workers

CPU = "cpu"
STRATEGIES = workers.STRATEGIES
N_OP, D_OP = 1024, 8           # the operator checks (test_partition.py:44)


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    with one_thread():
        yield


def _dense(n, density, seed):
    return workers.dense_graph(n, density, seed)


def _pair(dense):
    return tsp.from_dense(dense, device=CPU), jsp.from_dense(dense)


def _hic_pair(n_valid, n_pad, seed):
    edges = make_hic_edges(n_valid, 4 * n_valid, seed=seed)
    kw = dict(n_valid=n_valid, n_pad=n_pad, hic_edges=edges)
    return tsp.build_chrom_graph("hic", device=CPU, **kw), jsp.build_chrom_graph("hic", **kw)


GRAPHS = {
    "dense64": lambda: _pair(_dense(64, 0.05, 0)),
    "hic1024": lambda: _hic_pair(1000, 1024, 3),
}


# ---------------------------------------------------------------------------
# the partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_partition_arrays_equal_jax(name, n_shards):
    tg, jg = GRAPHS[name]()
    ours, ref = partition_graph(tg, n_shards), jgraph.partition_graph(jg, n_shards)
    assert (ours.n_shards, ours.rows_per_shard, ours.halo_widths) == (
        ref.n_shards, ref.rows_per_shard, ref.halo_widths)
    for field in ("senders", "receivers_local", "vals", "node_mask", "senders_halo"):
        got, want = getattr(ours, field).numpy(), np.asarray(getattr(ref, field))
        assert got.dtype == want.dtype and np.array_equal(got, want), field
    assert len(ours.send_maps) == len(ref.send_maps) == n_shards - 1
    for got, want in zip(ours.send_maps, ref.send_maps):
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shard_forms_hold_jax_blocks(n_shards):
    """Each shard's local and halo operators hold the reference's live
    blocks (JAX pads every shard to the largest counts; the port's counts
    are each shard's own) and its halo columns; an empty halo has none."""
    tg, jg = _hic_pair(1000, 1024, 5)
    ours = attach_shard_bsr(partition_graph(tg, n_shards)).bsr
    ref = jgraph.attach_shard_bsr(jgraph.partition_graph(jg, n_shards)).bsr
    assert ours.halo_cols == ref.halo_cols
    for s in range(n_shards):
        for direction in ("fwd", "bwd"):
            pairs = [(getattr(ours.local[s], direction), getattr(ref, f"{direction}_local"))]
            if ours.halo[s] is not None:
                pairs.append((getattr(ours.halo[s], direction), getattr(ref, f"{direction}_halo")))
            else:
                for blocks in ("tiles", "strips") if ref.fwd_halo is not None else ():
                    assert not np.asarray(getattr(ref.fwd_halo, blocks)[s]).any()
            for m, stacked in pairs:
                for blocks in ("tile", "strip"):
                    n = m.nt if blocks == "tile" else m.ns
                    got = getattr(m, f"{blocks}s")[:n].numpy()
                    want = np.asarray(getattr(stacked, f"{blocks}s")[s])
                    np.testing.assert_array_equal(got, want[:n])
                    assert not want[n:].any()
                    for idx in ("rb", "cb"):
                        np.testing.assert_array_equal(
                            getattr(m, f"{blocks}_{idx}")[:n].numpy(),
                            np.asarray(getattr(stacked, f"{blocks}_{idx}")[s])[:n])


def test_partition_preserves_masks_and_edges():
    dense = _dense(32, 0.2, 3)
    pg = partition_graph(tsp.from_dense(dense, device=CPU), 4)
    assert pg.n_nodes == 32
    assert int((pg.vals != 0).sum()) == int((dense != 0).sum())


def test_partition_requires_divisible_nodes():
    with pytest.raises(ValueError, match="not divisible"):
        partition_graph(tsp.from_dense(_dense(48, 0.05, 0), device=CPU), 5)


def test_halo_widths_are_per_offset_not_global_max():
    """One dense boundary pair inflates only its own ring offset's width,
    offsets without edges skip their round, and the product is still
    exact (tests/test_partition.py:190)."""
    n, shards = 64, 8
    rows = n // shards
    s0 = np.repeat(np.arange(0, rows), rows)
    r1 = np.tile(np.arange(rows, 2 * rows), rows)
    senders = np.concatenate([s0, [2]]).astype(np.int32)
    receivers = np.concatenate([r1, [3 * rows + 1]]).astype(np.int32)
    edges = (senders, receivers, np.ones(len(senders), np.float32))
    g = tsp.build_chrom_graph("hic", n_valid=n, n_pad=n, hic_edges=edges, device=CPU)
    jg = jsp.build_chrom_graph("hic", n_valid=n, n_pad=n, hic_edges=edges)
    pg = partition_graph(g, shards)
    assert pg.halo_widths == jgraph.partition_graph(jg, shards).halo_widths
    assert len(pg.halo_widths) == shards - 1
    assert pg.halo_widths[0] >= pg.halo_widths[2] > 0
    assert any(w == 0 for w in pg.halo_widths)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(n, 4)).astype(np.float32))
    for strategy in ("halo", "all_gather"):
        torch.testing.assert_close(sharded_spmm(pg, x, strategy=strategy), spmm_coo(g, x),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the in-process product against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def operator_world():
    dense = _dense(N_OP, 0.01, 2)
    x = np.random.default_rng(1).normal(size=(N_OP, D_OP)).astype(np.float32)
    w = np.random.default_rng(2).normal(size=(N_OP, D_OP)).astype(np.float32)
    return dense, x, w


@pytest.fixture(scope="module")
def jax_operator(operator_world):
    """JAX's A x and gradient of sum(A x * w), one device."""
    dense, x, w = operator_world
    jg = jsp.from_dense(dense)
    out, vjp = jax.vjp(lambda xx: spmm_xla(jg, xx), jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(w))[0])


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_in_process_sharded_spmm_matches_jax(operator_world, jax_operator, n_shards, strategy):
    """A x and the gradient of sum(A x * w), every shard in this process,
    against JAX's."""
    dense, x, w = operator_world
    want, want_grad = jax_operator
    pg = partition_graph(tsp.from_dense(dense, device=CPU), n_shards)
    if strategy == "halo_bsr":
        pg = attach_shard_bsr(pg)
    xs = torch.from_numpy(x.copy()).requires_grad_()
    out = sharded_spmm(pg, xs, strategy=strategy)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xs.grad.numpy(), want_grad, rtol=1e-5, atol=1e-5)


def test_sharded_graph_routes_and_stays_unfused(operator_world):
    """ops.spmm routes a ShardedGraph to the sharded product whatever impl
    says, and the fused kernels take no sharded graph: -gcn_fused on runs
    the unfused layer (fused_fits is False), as in the reference."""
    dense, x, _ = operator_world
    g = tsp.from_dense(dense, device=CPU)
    sg = shard_graph(g.replace(bsr=object()), 4, strategy="auto")
    assert isinstance(sg, ShardedGraph) and sg.strategy == "halo_bsr"
    assert shard_graph(g, 4).strategy == "halo"
    xt = torch.from_numpy(x)
    for impl in ("auto", "xla", "pallas"):
        torch.testing.assert_close(spmm(sg, xt, impl=impl), spmm_coo(g, xt),
                                   rtol=1e-5, atol=1e-5)
    assert not fused_fits(sg.bsr, D_OP)
    model = ChromeGCN(nfeat=D_OP, nhid=D_OP, nclass=3, fused="on")
    assert not model._use_fused(xt, sg)


# ---------------------------------------------------------------------------
# the joint step on an in-process sharded graph
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_joint_reference():
    """JAX's JOINT steps on one device (tests/test_joint.py:104, DeepSEA,
    SGD), from the initial weights tests/test_torch_joint.py holds the port
    to: those weights in the port's layout, and JAX's losses and states."""
    (jw, jc), (tw, tc) = joint_states("deepsea", "sgd", workers.JOINT["lr"])
    init = {"window": workers.numpy_state(tw.model.state_dict()),
            "chrome": workers.numpy_state(tc.model.state_dict())}
    tokens, targets = workers.joint_inputs()
    jg = jsp.build_chrom_graph("constant", n_valid=workers.JOINT["n_valid"],
                               n_pad=workers.JOINT["n_pad"])
    comp = jnp.asarray(complement_permutation(SRC_VOCAB))
    losses = []
    for step in range(workers.JOINT["steps"]):
        jw, jc, loss = jjoint.joint_train_step(jw, jc, jnp.asarray(tokens), comp, jg,
                                               jnp.asarray(targets), jax.random.PRNGKey(step),
                                               chunk_size=workers.JOINT["chunk"])
        losses.append(float(loss))
    ref = {"losses": losses}
    for key, state, convert in (("window", jw, window_state_dict),
                                ("chrome", jc, chromegcn_state_dict)):
        ref[key] = {k: v.numpy() for k, v in convert(
            jax.device_get(state.params), jax.device_get(state.batch_stats)).items()}
    return init, ref


def assert_joint_matches(got, ref, where):
    """Each loss to rel 1e-5, every tensor of both models at the steps'
    parameter tolerance (rtol 1e-4, atol 1e-6). The GCN's biases before its
    BatchNorm move by rounding-level gradients (to ~4e-5 in two steps),
    where the one-device port already differs from JAX by ~3e-9, so a
    tolerance relative to their own scale would test rounding."""
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5, err_msg=f"{where} losses")
    for model in ("window", "chrome"):
        for key, want in ref[model].items():
            np.testing.assert_allclose(got[model][key], want, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{where} {model} {key}")


def test_in_process_joint_steps_match_jax():
    """Two joint steps (DeepSEA + the GCN) on a graph of 4 in-process shards
    against JAX's one-device steps from the same weights."""
    init, ref = jax_joint_reference()
    tokens, targets = workers.joint_inputs()
    g = tsp.build_chrom_graph("constant", n_valid=workers.JOINT["n_valid"],
                              n_pad=workers.JOINT["n_pad"], device=CPU)
    got = workers.joint_run(shard_graph(g, 4, strategy="halo"), tokens, targets, init)
    assert_joint_matches(got, ref, "in-process")


# ---------------------------------------------------------------------------
# row placement, meshes, tensor-parallel rule (no process group)
# ---------------------------------------------------------------------------


def test_local_row_range_two_and_four_hosts():
    """tests/test_multihost.py's layouts, one rank a device: two ranks, and
    four."""
    assert multihost.local_row_range(512, 0, 2) == (0, 256)
    assert multihost.local_row_range(512, 1, 2) == (256, 512)
    for rank in range(4):
        assert multihost.local_row_range(1024, rank, 4) == (rank * 256, (rank + 1) * 256)


def test_local_row_range_rejects_bad_layouts():
    """A rank outside the world owns no rows, and rows that do not cut
    evenly are refused. (The reference's non-contiguous layout, one process
    holding scattered devices' shards, cannot arise with a rank a device.)"""
    for rank in (7, 2, -1):
        with pytest.raises(ValueError, match="owns no shard"):
            multihost.local_row_range(128, rank, 2)
    with pytest.raises(ValueError, match="equal shards"):
        multihost.local_row_range(130, 0, 4)


def test_put_global_and_host_batch_slice():
    x = np.arange(32 * 2, dtype=np.float32).reshape(32, 2)
    assert multihost.put_global(x, 0, 1) is x
    np.testing.assert_array_equal(multihost.put_global(x, 1, 2), x[16:])
    np.testing.assert_array_equal(multihost.put_global(x[:16], 0, 2, already_local=True),
                                  x[:16])
    with pytest.raises(ValueError, match="owns no shard"):
        # a rank outside the world holds no rows of the global extent
        multihost.put_global(x[:12], 2, 2, already_local=True)
    assert multihost.host_batch_slice(64, 1, 2) == (32, 64)
    with pytest.raises(ValueError, match="equal shards"):
        multihost.host_batch_slice(63, 1, 2)


def test_meshes_need_their_ranks():
    """Alone, a process is one rank: a mesh of more raises (the reference
    raises when its mesh lacks devices), and without torchrun's environment
    init_distributed does nothing."""
    assert not tmesh.init_distributed(CPU)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_mesh(2, axis="graph")
    with pytest.raises(ValueError, match=r"mesh 2x2 needs 4 ranks"):
        tmesh.make_mesh_2d(2, 2)
    one = tmesh.make_mesh(1, axis="graph")
    assert one.size("graph") == 1 and one.index("graph") == 0 and one.group("graph") is None
    grid = tmesh.Mesh(("data", "model"), (2, 3), 4, {"data": None, "model": None})
    assert (grid.index("data"), grid.index("model")) == (1, 1)
    assert tmesh.backend_for(torch.device("cuda")) == "nccl"
    assert tmesh.backend_for(torch.device("cpu")) == "gloo"


def test_a_cuda_run_never_joins_a_gloo_group(tmp_path, monkeypatch):
    """A group whose backend cannot carry the device's tensors is refused,
    never used."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(RuntimeError, match="need nccl"):
            tmesh.init_distributed("cuda")
        monkeypatch.undo()
        assert tmesh.init_distributed(CPU)
    finally:
        dist.destroy_process_group()
