"""Rank functions for the parallel tests of the port (tests/test_torch_parallel*.py).

The tests spawn N processes, each one rank of a gloo process group, and run
a list of tasks in each. A spawned process imports this module afresh, so
it imports nothing of JAX (tests/conftest.py forces JAX's virtual devices;
the JAX references run in the parent, and their numbers come here as numpy
arrays). Each rank runs torch on one thread: the test workers share the
cores. Results go back through one ``torch.save`` file per rank.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from chromegcn_tpu_torch.data.constants import SRC_VOCAB
from chromegcn_tpu_torch.models.chrome import ChromeGCN, ChromeRNN
from chromegcn_tpu_torch.models.strand import NonStrandSpecific
from chromegcn_tpu_torch.models.window import make_window_model
from chromegcn_tpu_torch.ops import sparse as tsp
from chromegcn_tpu_torch.ops.seq import complement_permutation
from chromegcn_tpu_torch.ops.spmm import spmm
from chromegcn_tpu_torch.parallel import tp
from chromegcn_tpu_torch.parallel.graph import shard_graph
from chromegcn_tpu_torch.parallel.mesh import (
    gather_rows, init_distributed, make_mesh, make_mesh_2d,
)
from chromegcn_tpu_torch.parallel.multihost import host_batch_slice, put_global
from chromegcn_tpu_torch.train import finetune as tft
from chromegcn_tpu_torch.train import joint as tjoint
from chromegcn_tpu_torch.train import pretrain as tpt
from chromegcn_tpu_torch.train.optim import make_optimizer

CPU = "cpu"
STRATEGIES = ("all_gather", "halo", "halo_bsr")
# a deadlocked collective fails the test in this time, not gloo's 30 min
TIMEOUT = timedelta(seconds=120)


def dense_graph(n, density, seed):
    """The reference tests' random graph (tests/test_partition.py:_graph)."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n)) < density).astype(np.float32)
    dense *= rng.random((n, n)).astype(np.float32)
    return dense


def band_graph(n_pad, n_valid, width, density, seed):
    """A contact map's shape: random entries within ``width`` of the
    diagonal among the first ``n_valid`` nodes, none on the padding rows."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((n_pad, n_pad), np.float32)
    i, j = np.indices((n_valid, n_valid))
    near = (np.abs(i - j) <= width) & (rng.random((n_valid, n_valid)) < density)
    dense[:n_valid, :n_valid] = near * rng.random((n_valid, n_valid)).astype(np.float32)
    return dense


def no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def numpy_state(sd):
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


# ---------------------------------------------------------------------------
# tasks: (rank, world, **kwargs) -> a picklable result
# ---------------------------------------------------------------------------


def operator(rank, world, dense, x, w):
    """Each strategy's distributed product on this rank's rows, and the
    gradient of sum(A x * w) with respect to them."""
    g = tsp.from_dense(dense, device=CPU)
    out = {}
    for strategy in STRATEGIES:
        sg = shard_graph(g, world, strategy=strategy, group=dist.group.WORLD)
        xs = torch.from_numpy(put_global(x, rank, world).copy()).requires_grad_()
        y = spmm(sg, xs)
        (y * torch.from_numpy(put_global(w, rank, world))).sum().backward()
        out[strategy] = (y.detach().numpy(), xs.grad.numpy())
    return out


def gcn_step(rank, world, dense, init, x_f, x_r, targets, nclass, strategy, n_valid=None,
             dropout=0.0):
    """One train step and one eval step of the GCN on a graph sharded over
    the ranks, from ``init``; the probabilities gathered. With ``dropout``
    the masks come from a generator seeded 5 on every rank."""
    d = x_f.shape[1]
    g = tsp.from_dense(dense, n_valid=n_valid, device=CPU)
    sg = shard_graph(g, world, strategy=strategy, group=dist.group.WORLD)
    model = ChromeGCN(nfeat=d, nhid=d, nclass=nclass, dropout=dropout, layers=2,
                      spmm_impl="pallas" if strategy == "halo_bsr" else "xla")
    state = tft.create_chrome_state(model, "sgd", 0.25, device=CPU)
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    rows = [put_global(a, rank, world) for a in (x_f, x_r, targets)]
    x_f, x_r, targets = rows
    generator = torch.Generator().manual_seed(5) if dropout else None
    _, loss, probs = tft.chrome_train_step(state, x_f, x_r, sg, targets, generator,
                                           device=CPU)
    eval_loss, eval_probs = tft.chrome_eval_step(state, x_f, x_r, sg, targets, device=CPU)
    return {"loss": loss.item(), "probs": gather_rows(probs, sg.group).numpy(),
            "state": numpy_state(state.model.state_dict()), "eval_loss": eval_loss.item(),
            "eval_probs": gather_rows(eval_probs, sg.group).numpy()}


def rnn_step(rank, world, init, x_f, x_r, targets, nclass, dropout=0.0):
    """One ChromeRNN train step on rows sharded over the ranks (the graph
    carries the mask and the group). With ``dropout`` the masks come from a
    generator seeded 5 on every rank."""
    n, d = x_f.shape
    g = tsp.build_chrom_graph("none", n_valid=n - 6, n_pad=n, device=CPU)
    sg = shard_graph(g, world, strategy="halo", group=dist.group.WORLD)
    model = ChromeRNN(nfeat=d, nclass=nclass, dropout=dropout, layers=2)
    state = tft.create_chrome_state(model, "sgd", 0.25, device=CPU)
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    x_f, x_r, targets = (put_global(a, rank, world) for a in (x_f, x_r, targets))
    generator = torch.Generator().manual_seed(5) if dropout else None
    _, loss, probs = tft.chrome_train_step(state, x_f, x_r, sg, targets, generator,
                                           device=CPU)
    return {"loss": loss.item(), "probs": gather_rows(probs, sg.group).numpy(),
            "state": numpy_state(state.model.state_dict())}


def window_step(rank, world, dp, tp_n, name, init, seq, d_model, ntargets, tokens, targets,
                mask, min_elements):
    """One window train step on a dp x tp mesh from ``init`` (dropout out),
    then the state in the full layout, and the eval step's features."""
    model = NonStrandSpecific(make_window_model(name, ntargets, seq_length=seq, d_model=d_model))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    no_dropout(model)
    state = tpt.WindowTrainState(model, make_optimizer("sgd", 0.25, model.parameters()))
    if dp > 1 and tp_n > 1:
        mesh = make_mesh_2d(dp, tp_n, axes=("data", "model"))
    elif tp_n > 1:
        mesh = make_mesh(tp_n, axis="model")
    else:
        mesh = make_mesh(dp, axis="data")
    if tp_n > 1:
        state = tp.place_window_state(state, mesh, min_elements=min_elements)
    if dp > 1:
        state = tpt.data_parallel(state, mesh.group("data"))
    d_idx = mesh.index("data") if "data" in mesh.axes else 0
    lo, hi = host_batch_slice(tokens.shape[0], d_idx, dp)
    comp = torch.as_tensor(complement_permutation(SRC_VOCAB))
    _, loss, probs = tpt.window_train_step(state, tokens[lo:hi], targets[lo:hi], mask[lo:hi],
                                           comp, device=CPU)
    if state.group is not None:
        probs = gather_rows(probs, state.group)
    eval_loss, _, x_f, _ = tpt.window_eval_step(state, tokens[lo:hi], targets[lo:hi],
                                                mask[lo:hi], comp, device=CPU)
    payload = tp.full_payload(state) if tp_n > 1 else {"model": state.model.state_dict()}
    return {"loss": loss.item(), "probs": probs.numpy(), "state": numpy_state(payload["model"]),
            "eval_loss": eval_loss.item(), "x_f": x_f.numpy(),
            "modules": sorted({type(m).__name__ for m in state.model.modules()})}


# the joint step of tests/test_joint.py:104, DeepSEA's CNN in place of
# Expecto's (cheaper on the CPU; the joint path is the same), SGD with
# momentum as tests/test_torch_joint.py's steps against JAX
JOINT = dict(seq=400, d=8, ntargets=7, n_pad=32, n_valid=30, chunk=8, steps=2, lr=0.05)


def joint_inputs():
    nprng = np.random.default_rng(1)
    tokens = nprng.integers(0, 4, size=(JOINT["n_pad"], JOINT["seq"])).astype(np.int32)
    targets = (nprng.random((JOINT["n_pad"], JOINT["ntargets"])) < 0.3).astype(np.float32)
    return tokens, targets


def joint_run(graph, tokens, targets, init):
    """JOINT's steps (DeepSEA and the GCN from ``init``'s "window" and
    "chrome" weights, SGD) on ``graph``: the losses and both models' states
    after them. On a graph sharded over a group, ``tokens`` and ``targets``
    are this rank's rows."""
    wmodel = NonStrandSpecific(make_window_model("deepsea", JOINT["ntargets"],
                                                 seq_length=JOINT["seq"], d_model=JOINT["d"]))
    cmodel = ChromeGCN(nfeat=JOINT["d"], nhid=JOINT["d"], nclass=JOINT["ntargets"],
                       dropout=0.0)
    for model, key in ((wmodel, "window"), (cmodel, "chrome")):
        model.load_state_dict({k: torch.from_numpy(v) for k, v in init[key].items()})
    wstate = tpt.WindowTrainState(wmodel, make_optimizer("sgd", JOINT["lr"], wmodel.parameters()))
    cstate = tft.ChromeTrainState(cmodel, make_optimizer("sgd", JOINT["lr"], cmodel.parameters()))
    comp = torch.as_tensor(complement_permutation(SRC_VOCAB))
    losses = [tjoint.joint_train_step(wstate, cstate, tokens, comp, graph, targets,
                                      chunk_size=JOINT["chunk"], device=CPU)[2].item()
              for _ in range(JOINT["steps"])]
    return {"losses": losses, "window": numpy_state(wmodel.state_dict()),
            "chrome": numpy_state(cmodel.state_dict())}


def joint_steps(rank, world, init):
    """JOINT's steps on its constant graph sharded over the ranks, each rank
    running its rows' chunks through the CNN."""
    g = tsp.build_chrom_graph("constant", n_valid=JOINT["n_valid"], n_pad=JOINT["n_pad"],
                              device=CPU)
    sg = shard_graph(g, world, strategy="halo", group=dist.group.WORLD)
    tokens, targets = (put_global(a, rank, world) for a in joint_inputs())
    return joint_run(sg, tokens, targets, init)


def cli(rank, world, argv, init=None):
    """The port's CLI as one of ``world`` ranks (the process group comes from
    the torchrun-style environment the launcher set); ``init``, if given,
    replaces the GCN's initial weights."""
    from chromegcn_tpu_torch import main as tmain

    if init is not None:
        create = tft.create_chrome_state

        def create_from(model, *args, **kwargs):
            state = create(model, *args, **kwargs)
            state.model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
            return state

        tft.create_chrome_state = create_from
    tmain.main(argv, device=CPU)
    return dist.get_world_size()


TASKS = {f.__name__: f for f in (operator, gcn_step, rnn_step, window_step, joint_steps, cli)}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, tasks, root, port):
    torch.set_num_threads(1)
    if port:
        # as torchrun sets it; the tasks' entry point joins the group
        os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    else:
        init_distributed(CPU, init_method=f"file://{os.path.join(root, 'store')}",
                         world_size=world, rank=rank, timeout=TIMEOUT)
    try:
        # "name:label" runs task name under its own key
        results = {key: TASKS[key.split(":")[0]](rank, world, **kwargs) for key, kwargs in tasks}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(results, os.path.join(root, f"rank{rank}.pt"))


def spawn(batteries, root, env=False):
    """Run each battery {world: [(task key, kwargs), ...]} in its own
    ``world`` spawned ranks of a gloo group, all batteries at once; returns
    {world: [each rank's {task key: result}]}; a key is a task's name,
    or "name:label" to run one task more than once. ``env``: the ranks find
    their group through torchrun's environment variables (a loopback port),
    else through a file store under ``root``."""
    contexts = {}
    for world, tasks in batteries.items():
        out = os.path.join(str(root), f"world{world}")
        os.makedirs(out, exist_ok=True)
        contexts[world] = (out, torch.multiprocessing.start_processes(
            _rank_main, args=(world, tasks, out, _free_port() if env else 0),
            nprocs=world, join=False, start_method="spawn"))
    for _, ctx in contexts.values():
        while not ctx.join():
            pass
    return {world: [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                    for r in range(world)]
            for world, (out, _) in contexts.items()}
