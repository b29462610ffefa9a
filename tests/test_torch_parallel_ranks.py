"""The port's parallel paths across processes: spawned gloo ranks
(tests/torch_parallel_workers.py, one thread each, every world size's
battery at once) against JAX on the CPU and against the port's in-process
mode and one-device runs.

- the operator: each rank's rows of A x and of its gradient, for every
  strategy, equal the in-process product's within 1e-6;
- the graph-sharded GCN step (halo_bsr at 2 ranks, halo at 4): BatchNorm's
  statistics, the loss and the gradients reduced over the ranks, against
  JAX's step at tests/test_partition.py's tolerances (loss rtol 1e-5,
  probabilities 1e-4 / 1e-5, parameters 1e-4 / 1e-6); so is the step on
  an in-process sharded graph;
- Expecto's step data-parallel over 2 ranks and on a 2 x 2 data x tensor
  mesh, its flatten-Dense row-parallel, against JAX's, and the tensor
  rule's choice against JAX's;
- ChromeRNN and the joint steps on rows sharded over 2 ranks against JAX's;
- a halo_bsr step over 4 ranks on a padded graph whose last two shards are
  all padding (no halo, yet in the ring's rounds), against JAX's;
- with dropout on, the GCN and ChromeRNN steps over 4 ranks against the
  port's one-device steps from the same generator seed: the ranks draw one
  mask for all rows and keep theirs.

The JAX side is its one-device step, which JAX's own sharded steps equal
(tests/test_partition.py); a JAX step over the conftest's virtual devices
costs seconds more each. Dropout is out on both sides wherever JAX is the
reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromegcn_tpu.models.chrome import ChromeGCN as JaxChromeGCN
from chromegcn_tpu.models.chrome import ChromeRNN as JaxChromeRNN
from chromegcn_tpu.models.window import Expecto as JaxExpecto
from chromegcn_tpu.ops import sparse as jsp
from chromegcn_tpu.parallel import tp as jtp
from chromegcn_tpu.parallel.mesh import make_mesh_2d as jax_make_mesh_2d
from chromegcn_tpu.train import finetune as jft
from chromegcn_tpu.train import pretrain as jpt
from chromegcn_tpu.train.optim import make_optimizer as jax_make_optimizer
from chromegcn_tpu_torch.data.constants import SRC_VOCAB
from chromegcn_tpu_torch.models.chrome import ChromeGCN, ChromeRNN
from chromegcn_tpu_torch.ops import sparse as tsp
from chromegcn_tpu_torch.ops.seq import complement_permutation
from chromegcn_tpu_torch.parallel import multihost
from chromegcn_tpu_torch.parallel import tp as ttp
from chromegcn_tpu_torch.parallel.graph import attach_shard_bsr, partition_graph, shard_graph, sharded_spmm
from chromegcn_tpu_torch.train import finetune as tft
from chromegcn_tpu_torch.utils.convert import (
    chromegcn_state_dict, chromernn_state_dict, window_state_dict,
)
from test_torch_parallel import assert_joint_matches, jax_joint_reference
from test_torch_rnn import one_thread
import torch_parallel_workers as workers

CPU = "cpu"
STRATEGIES = workers.STRATEGIES
DROPOUT = 0.5
N_GCN, D_GCN, NCLS = 1024, 16, 6  # the GCN step (test_partition.py:71)
# a chromosome padded to a bucket: over 4 ranks the last two shards are all
# padding, and shard 1 reads shard 0's rows
N_PADDED, VALID_PADDED = 1024, 400
SEQ, D_WIN, NT_WIN, BATCH = 400, 16, 6, 8  # the window steps (test_partition.py:134)


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    with one_thread():
        yield


def _pair(dense):
    return tsp.from_dense(dense, device=CPU), jsp.from_dense(dense)


# ---------------------------------------------------------------------------
# the JAX references of the steps
# ---------------------------------------------------------------------------


def _jax_gcn_world(dense, n_valid=None):
    """The GCN step of tests/test_partition.py:68 on ``dense``: JAX's initial
    weights, inputs, and JAX's step."""
    jg = jsp.from_dense(dense, n_valid=n_valid)
    n = dense.shape[0]
    nprng = np.random.default_rng(1)
    x_f = nprng.normal(size=(n, D_GCN)).astype(np.float32)
    x_r = nprng.normal(size=(n, D_GCN)).astype(np.float32)
    targets = (nprng.random((n, NCLS)) < 0.3).astype(np.float32)
    model = JaxChromeGCN(nfeat=D_GCN, nhid=D_GCN, nclass=NCLS, dropout=0.0, layers=2)
    rng = jax.random.PRNGKey(0)

    def new_state():
        return jft.create_chrome_state(model, jax_make_optimizer("sgd", 0.25), rng,
                                       nfeat=D_GCN, n_nodes=128)

    st = new_state()
    init = {k: v.numpy() for k, v in chromegcn_state_dict(
        jax.device_get(st.params), jax.device_get(st.batch_stats)).items()}
    st, loss, probs = jft.chrome_train_step(new_state(), jnp.asarray(x_f), jnp.asarray(x_r), jg,
                                            jnp.asarray(targets), rng)
    ref = {"loss": float(loss), "probs": np.asarray(probs),
           "state": {k: v.numpy() for k, v in chromegcn_state_dict(
               jax.device_get(st.params), jax.device_get(st.batch_stats)).items()}}
    return {"dense": dense, "n_valid": n_valid, "init": init, "x_f": x_f, "x_r": x_r,
            "targets": targets, "ref": ref}


@pytest.fixture(scope="module")
def gcn_world():
    return _jax_gcn_world(workers.dense_graph(N_GCN, 0.01, 4))


@pytest.fixture(scope="module")
def padded_world():
    """The same step on a band graph of 400 valid nodes padded to 1024."""
    return _jax_gcn_world(workers.band_graph(N_PADDED, VALID_PADDED, 24, 0.3, 6),
                          n_valid=VALID_PADDED)


def _gcn_kwargs(world):
    return {k: world[k] for k in ("dense", "n_valid", "init", "x_f", "x_r", "targets")}


def _assert_step(got, ref, where):
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5, err_msg=f"{where} loss")
    np.testing.assert_allclose(got["probs"], ref["probs"], rtol=1e-4, atol=1e-5,
                               err_msg=f"{where} probs")
    for key, want in ref["state"].items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got["state"][key], want, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{where} {key}")


@pytest.mark.parametrize("strategy", ["halo", "halo_bsr"])
def test_in_process_gcn_step_matches_jax(gcn_world, strategy):
    """The unchanged train step on an in-process ShardedGraph of 8 shards
    matches JAX's."""
    w = gcn_world
    g = tsp.from_dense(w["dense"], device=CPU)
    model = ChromeGCN(nfeat=D_GCN, nhid=D_GCN, nclass=NCLS, dropout=0.0, layers=2)
    state = tft.create_chrome_state(model, "sgd", 0.25, device=CPU)
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in w["init"].items()})
    sg = shard_graph(g, 8, strategy=strategy)
    _, loss, probs = tft.chrome_train_step(state, w["x_f"], w["x_r"], sg, w["targets"],
                                           device=CPU)
    got = {"loss": loss.item(), "probs": probs.numpy(),
           "state": {k: v.numpy() for k, v in state.model.state_dict().items()}}
    _assert_step(got, w["ref"], f"in-process {strategy}")


@pytest.fixture(scope="module")
def window_world():
    """Expecto (seq 400, d_model 16) from JAX's initial weights, a batch of 8
    with two padded rows, and JAX's one-device SGD step, dropout out (the
    sharded JAX step equals it: tests/test_partition.py:116)."""
    from flax import linen as flax_nn

    model = JaxExpecto(n_targets=NT_WIN, seq_length=SEQ, d_model=D_WIN)
    rng = jax.random.PRNGKey(0)
    state = jpt.create_window_state(model, jax_make_optimizer("sgd", 0.25), rng, SEQ,
                                    SRC_VOCAB, batch_size=2)
    init = {k: v.numpy() for k, v in window_state_dict(
        jax.device_get(state.params), jax.device_get(state.batch_stats)).items()}
    nprng = np.random.default_rng(0)
    tokens = nprng.integers(0, 4, size=(BATCH, SEQ)).astype(np.int32)
    targets = (nprng.random((BATCH, NT_WIN)) < 0.3).astype(np.float32)
    mask = np.ones(BATCH, bool)
    mask[-2:] = False
    comp = jnp.asarray(complement_permutation(SRC_VOCAB))
    jax_params = jax.tree_util.tree_map(np.array, jax.device_get(state.params))
    saved = flax_nn.Dropout.__call__
    jax.clear_caches()
    flax_nn.Dropout.__call__ = lambda self, x, *a, **k: x
    try:
        st, loss, probs = jpt.window_train_step(state, jnp.asarray(tokens), jnp.asarray(targets),
                                                jnp.asarray(mask), comp, rng)
        eval_loss, _, x_f, _ = jpt.window_eval_step(st, jnp.asarray(tokens),
                                                    jnp.asarray(targets), jnp.asarray(mask), comp)
    finally:
        flax_nn.Dropout.__call__ = saved
        jax.clear_caches()
    ref = {"loss": float(loss), "probs": np.asarray(probs), "eval_loss": float(eval_loss),
           "x_f": np.asarray(x_f),
           "state": {k: v.numpy() for k, v in window_state_dict(
               jax.device_get(st.params), jax.device_get(st.batch_stats)).items()}}
    return {"init": init, "tokens": tokens, "targets": targets, "mask": mask, "ref": ref,
            "jax_params": jax_params, "torch_shapes": {k: tuple(v.shape)
                                                        for k, v in init.items()}}


@pytest.fixture(scope="module")
def rnn_world():
    """ChromeRNN (d 8, 2 layers) from JAX's initial weights, and JAX's SGD
    step (tests/test_torch_rnn.py holds the port's one-device step to it)."""
    n, d = 64, 8
    jg = jsp.build_chrom_graph("none", n_valid=n - 6, n_pad=n)
    nprng = np.random.default_rng(3)
    x_f, x_r = (nprng.normal(size=(n, d)).astype(np.float32) for _ in range(2))
    targets = (nprng.random((n, NCLS)) < 0.3).astype(np.float32)
    model = JaxChromeRNN(nfeat=d, nclass=NCLS, dropout=0.0, layers=2)
    st = jft.create_chrome_state(model, jax_make_optimizer("sgd", 0.25), jax.random.PRNGKey(2),
                                 nfeat=d)
    init = {k: v.numpy() for k, v in chromernn_state_dict(
        jax.device_get(st.params), jax.device_get(st.batch_stats)).items()}
    st, loss, probs = jft.chrome_train_step(st, jnp.asarray(x_f), jnp.asarray(x_r), jg,
                                            jnp.asarray(targets), jax.random.PRNGKey(0))
    ref = {"loss": float(loss), "probs": np.asarray(probs),
           "state": {k: v.numpy() for k, v in chromernn_state_dict(
               jax.device_get(st.params), jax.device_get(st.batch_stats)).items()}}
    return {"init": init, "x_f": x_f, "x_r": x_r, "targets": targets, "ref": ref}


def _one_device_step(world, dropout, rnn=False):
    """The port's one-device step from ``world``'s weights with dropout on,
    its masks from a generator seeded 5, as the ranks seed theirs."""
    x_f = world["x_f"]
    n, d = x_f.shape
    if rnn:
        g = tsp.build_chrom_graph("none", n_valid=n - 6, n_pad=n, device=CPU)
        model = ChromeRNN(nfeat=d, nclass=NCLS, dropout=dropout, layers=2)
    else:
        g = tsp.from_dense(world["dense"], n_valid=world["n_valid"], device=CPU)
        model = ChromeGCN(nfeat=d, nhid=d, nclass=NCLS, dropout=dropout, layers=2)
    state = tft.create_chrome_state(model, "sgd", 0.25, device=CPU)
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in world["init"].items()})
    _, loss, probs = tft.chrome_train_step(state, x_f, world["x_r"], g, world["targets"],
                                           torch.Generator().manual_seed(5), device=CPU)
    return {"loss": loss.item(), "probs": probs.numpy(),
            "state": {k: v.numpy() for k, v in state.model.state_dict().items()}}


@pytest.fixture(scope="module")
def operator_world():
    dense = workers.dense_graph(1024, 0.01, 2)
    x = np.random.default_rng(1).normal(size=(1024, 8)).astype(np.float32)
    w = np.random.default_rng(2).normal(size=(1024, 8)).astype(np.float32)
    return dense, x, w


# ---------------------------------------------------------------------------
# spawned gloo ranks: one battery per world size
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, operator_world, gcn_world, padded_world, window_world, rnn_world):
    dense, x, w = operator_world
    ww = window_world
    gcn = dict(_gcn_kwargs(gcn_world), nclass=NCLS)
    window = dict(name="expecto", init=ww["init"], seq=SEQ, d_model=D_WIN, ntargets=NT_WIN,
                  tokens=ww["tokens"], targets=ww["targets"], mask=ww["mask"],
                  min_elements=1024)
    rnn = {k: rnn_world[k] for k in ("init", "x_f", "x_r", "targets")}
    batteries = {
        2: [("operator", dict(dense=dense, x=x, w=w)),
            ("gcn_step", dict(gcn, strategy="halo_bsr")),
            ("window_step", dict(window, dp=2, tp_n=1)),
            ("rnn_step", dict(rnn, nclass=NCLS)),
            ("joint_steps", dict(init=jax_joint_reference()[0]))],
        4: [("operator", dict(dense=dense, x=x, w=w)),
            ("gcn_step", dict(gcn, strategy="halo")),
            ("gcn_step:padded", dict(_gcn_kwargs(padded_world), nclass=NCLS,
                                     strategy="halo_bsr")),
            ("window_step", dict(window, dp=2, tp_n=2)),
            ("gcn_step:dropout", dict(gcn, strategy="halo_bsr", dropout=DROPOUT)),
            ("rnn_step:dropout", dict(rnn, nclass=NCLS, dropout=DROPOUT))],
    }
    return workers.spawn(batteries, tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("world", [2, 4])
def test_distributed_operator_matches_in_process(ranks, operator_world, world, strategy):
    """Each rank's rows of A x and of the gradient, over gloo, equal the
    in-process product's within 1e-6 (the all-reduce of a gradient sums in
    another order)."""
    dense, x, w = operator_world
    pg = partition_graph(tsp.from_dense(dense, device=CPU), world)
    if strategy == "halo_bsr":
        pg = attach_shard_bsr(pg)
    xs = torch.from_numpy(x.copy()).requires_grad_()
    out = sharded_spmm(pg, xs, strategy=strategy)
    (out * torch.from_numpy(w)).sum().backward()
    got = np.concatenate([r["operator"][strategy][0] for r in ranks[world]])
    got_grad = np.concatenate([r["operator"][strategy][1] for r in ranks[world]])
    np.testing.assert_allclose(got, out.detach().numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_grad, xs.grad.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_gcn_step_matches_jax(ranks, gcn_world, world):
    """The graph-sharded GCN train step over gloo ranks (halo_bsr at 2, halo
    at 4): BatchNorm's statistics, the loss and the gradients reduced over
    the ranks, against JAX's step."""
    for rank, res in enumerate(ranks[world]):
        _assert_step(res["gcn_step"], gcn_world["ref"], f"{world} ranks, rank {rank}")
    eval_losses = {res["gcn_step"]["eval_loss"] for res in ranks[world]}
    assert len(eval_losses) == 1  # every rank holds the global loss


def test_data_parallel_window_step_matches_jax(ranks, window_world):
    """-dp_devices 2: each rank trains on 4 rows of the batch of 8 (one of
    them padding), BatchNorm synced over both, against JAX's step."""
    for rank, res in enumerate(ranks[2]):
        _assert_step(res["window_step"], window_world["ref"], f"dp rank {rank}")
        assert "GroupBatchNorm1d" in res["window_step"]["modules"]


def test_data_tensor_parallel_window_step_matches_jax(ranks, window_world):
    """A 2 x 2 dp x tp mesh: Expecto's flatten-Dense row-parallel over the
    model axis, the batch over the data axis; the gathered state, the loss
    and the probabilities against JAX's step, and the eval features."""
    ref = window_world["ref"]
    for rank, res in enumerate(ranks[4]):
        got = res["window_step"]
        _assert_step(got, ref, f"dp x tp rank {rank}")
        assert "RowParallelLinear" in got["modules"]
        np.testing.assert_allclose(got["eval_loss"], ref["eval_loss"], rtol=1e-5)
        lo, hi = multihost.host_batch_slice(BATCH, rank // 2, 2)
        np.testing.assert_allclose(got["x_f"], ref["x_f"][lo:hi], rtol=1e-4, atol=1e-5)


def test_distributed_rnn_step_matches_jax(ranks, rnn_world):
    """ChromeRNN on rows sharded over 2 ranks: each gathers the sequence,
    runs it and keeps its rows; the step against JAX's."""
    for rank, res in enumerate(ranks[2]):
        _assert_step(res["rnn_step"], rnn_world["ref"], f"rnn rank {rank}")


def test_distributed_joint_steps_match_jax(ranks):
    """Two joint steps (DeepSEA + the GCN) with the graph over 2 ranks, each
    running its rows' chunks through the CNN, against JAX's one-device
    steps from the same weights (tests/test_joint.py:104)."""
    _, ref = jax_joint_reference()
    for rank, res in enumerate(ranks[2]):
        assert_joint_matches(res["joint_steps"], ref, f"rank {rank}")


def test_halo_bsr_step_with_all_padding_shards_matches_jax(ranks, padded_world):
    """halo_bsr over 4 ranks on a chromosome padded to a bucket: shards 2
    and 3 hold only padding and have no halo, yet receive blocks in the
    rounds that shards 0 and 1 need, and must send their zero cotangents
    back in the backward's reverse ring, or the owners wait on them. The
    step against JAX's."""
    pg = partition_graph(tsp.from_dense(padded_world["dense"], n_valid=VALID_PADDED,
                                        device=CPU), 4)
    sb = attach_shard_bsr(pg).bsr
    assert pg.halo_widths[0] > 0 and sb.halo[2] is None and sb.halo[3] is None
    for rank, res in enumerate(ranks[4]):
        _assert_step(res["gcn_step:padded"], padded_world["ref"], f"padded rank {rank}")


@pytest.mark.parametrize("rnn", [False, True], ids=["gcn", "rnn"])
def test_sharded_dropout_matches_one_device(ranks, gcn_world, rnn_world, rnn):
    """Dropout on (p 0.5), the generator seeded alike on every rank: the
    step over 4 ranks equals the one-device step from the same seed, since
    each rank draws the whole mask and keeps its rows."""
    key = "rnn_step:dropout" if rnn else "gcn_step:dropout"
    want = _one_device_step(rnn_world if rnn else gcn_world, DROPOUT, rnn=rnn)
    for rank, res in enumerate(ranks[4]):
        _assert_step(res[key], want, f"{key} rank {rank}")


def test_tp_rule_picks_jax_dims(window_world):
    """shard_large_arrays picks, for each Linear, the logical dimension
    JAX's rule shards (flax kernels are (in, out), torch weights (out,
    in)), here Expecto's flatten-Dense over its in-features."""
    placed = jtp.shard_large_arrays(window_world["jax_params"],
                                    jax_make_mesh_2d(4, 2, ("data", "model")), min_elements=1024)
    plan = ttp.shard_large_arrays(window_world["torch_shapes"], 2, min_elements=1024)
    for name in ("linear", "classifier"):
        spec = tuple(placed["model"][name]["kernel"].sharding.spec)
        jax_dim = spec.index("model") if "model" in spec else None
        ours = plan[f"model.{name}.weight"]
        assert ours == (None if jax_dim is None else 1 - jax_dim), name
    assert plan["model.linear.weight"] == 1  # in-features: row-parallel
