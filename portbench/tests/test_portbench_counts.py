"""The yardstick's counts against values worked out by hand at small shapes,
and against the port's own modules where both count the same thing."""

import numpy as np
import pytest
import torch

from portbench import flops, harness, traffic
from portbench.reference import gcn

SMALL_GCN = {"nfeat": 4, "nhid": 4, "nclass": 3, "layers": 2, "strands": 2}
SMALL_CNN = {
    "seq_length": 10, "strands": 2, "batch_size": 3,
    "layers": [{"op": "embed", "name": "e", "vocab": 5, "dim": 2},
               {"op": "conv", "name": "c1", "in": 2, "out": 3, "k": 3},
               {"op": "relu"}, {"op": "maxpool", "k": 2},
               {"op": "conv", "name": "c2", "in": 3, "out": 4, "k": 2},
               {"op": "flatten"},
               {"op": "linear", "name": "l1", "in": "flat", "out": 5},
               {"op": "linear", "name": "l2", "in": 5, "out": 2}],
}


def test_gcn_step_flops_by_hand():
    # n 10, nnz 30, d 4, 3 labels: GEMM 2*10*16 = 320, product 2*30*4 = 240,
    # gate 2*10*4 = 80; layer 1: 640 forward + 720 backward (no input
    # gradient), layer 2: 640 + 1040; two strands; head 3 * 2*10*4*3 = 720
    assert flops.gcn_step_flops(SMALL_GCN, n_valid=10, nnz=30) == 2 * (1360 + 1680) + 720


def test_window_counts_by_hand():
    # conv1 8 positions x 3 x 2 x 3 = 144; pool to 4; conv2 3 x 4 x 3 x 2 =
    # 72; flat 12; linear 12 x 5 = 60; linear 5 x 2 = 10
    assert flops.window_forward_macs(SMALL_CNN) == [144, 72, 60, 10]
    assert flops.window_step_flops(SMALL_CNN) == 3 * 2 * 286 * 2 * 3


def test_window_counts_match_the_ports_expecto_by_hooks():
    from chromegcn_tpu_torch.models.window import make_window_model

    cfg = harness.load_json("configs", "expecto_gm12878")
    model = make_window_model("expecto", cfg["n_targets"], cfg["seq_length"], cfg["d_model"])
    macs = []

    def hook(mod, inputs, out):
        if isinstance(mod, torch.nn.Conv1d):
            macs.append(out.numel() * mod.in_channels * mod.kernel_size[0])
        else:
            macs.append(out.numel() * mod.in_features)

    for m in model.modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.Linear)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model.eval()(torch.zeros((1, cfg["seq_length"]), dtype=torch.long))
    assert macs == flops.window_forward_macs(cfg)


def test_spmm_bytes_by_hand():
    # 30 nonzeros x (4 B value + 4 B column) + 11 row pointers x 4 B + x and
    # out, 10 x 4 f32 each
    assert flops.spmm_bytes(n_rows=10, nnz=30, d=4) == 240 + 44 + 320
    assert flops.spmm_bound_s(10, 30, 4) == pytest.approx(604 / 3.35e12)


def test_adjacency_nonzeros_are_the_ports_operator():
    from chromegcn_tpu_torch.ops.sparse import build_chrom_graph

    edges = traffic.make_hic_edges(3000, 6000, seed=3, hubness=0.6, compartment_frac=0.15)
    rows, cols, vals = gcn.adjacency(edges[0], edges[1], 3000)
    graph = build_chrom_graph("hic", n_valid=3000, n_pad=4096, hic_edges=edges, device="cpu")
    ne = graph.n_edges
    assert len(rows) == ne
    ours = sorted(zip(rows.tolist(), cols.tolist()))
    theirs = sorted(zip(graph.receivers[:ne].tolist(), graph.senders[:ne].tolist()))
    assert ours == theirs
    np.testing.assert_allclose(np.bincount(rows, weights=vals), np.ones(3000))


def test_hic_edges_are_the_ports_generator():
    from chromegcn_tpu_torch.data.synthetic import make_hic_edges

    ours = traffic.make_hic_edges(5000, 9000, seed=11, hubness=0.6, compartment_frac=0.15)
    theirs = make_hic_edges(5000, 9000, seed=11, hubness=0.6, compartment_frac=0.15)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 40])
def test_sub_seeds_differ_and_fit_a_generator(seed):
    seeds = {traffic.sub_seed(seed, k) for k in range(4)}
    assert len(seeds) == 4 and all(0 <= s < 2 ** 63 for s in seeds)
    torch.Generator().manual_seed(max(seeds))
