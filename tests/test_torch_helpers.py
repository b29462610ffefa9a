"""Port parity: the helper modules (ops/reorder, utils/torch_port,
utils/profiling, utils/parity) against the JAX package's, on the CPU.

torch_port's oracle is the composition of the JAX package's torch_port (the
original PyTorch checkpoints onto flax) and the port's utils/convert.py
(flax onto the port's modules), over checkpoints of the original models as
tests/test_window_models.py and tests/test_chrome_models.py build them.
"""

import os

import numpy as np
import pytest
import torch

from chromegcn_tpu.ops import reorder as jreorder
from chromegcn_tpu.ops import sparse as jsp
from chromegcn_tpu.utils import parity as jparity
from chromegcn_tpu.utils import torch_port as jport
from chromegcn_tpu_torch.data.synthetic import make_hic_edges
from chromegcn_tpu_torch.models.chrome import make_chrome_model
from chromegcn_tpu_torch.models.window import make_window_model
from chromegcn_tpu_torch.ops import reorder as treorder
from chromegcn_tpu_torch.ops import sparse as tsp
from chromegcn_tpu_torch.ops.spmm import spmm, spmm_coo
from chromegcn_tpu_torch.ops.spmm_bsr import attach_bsr
from chromegcn_tpu_torch.utils import parity as tparity
from chromegcn_tpu_torch.utils import profiling as tprofiling
from chromegcn_tpu_torch.utils import torch_port as tport
from chromegcn_tpu_torch.utils.convert import (
    chromegcn_state_dict, chromernn_state_dict, window_state_dict,
)
from test_chrome_models import TorchChromeRNN
from test_window_models import TorchDanQ, TorchDeepSEA, TorchExpecto, _randomize_bn_stats

CPU = "cpu"


# ---------------------------------------------------------------------------
# reorder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def graphs():
    kw = dict(n_valid=900, n_pad=1024, hic_edges=make_hic_edges(900, 4000, seed=3))
    return tsp.build_chrom_graph("hic", device=CPU, **kw), jsp.build_chrom_graph("hic", **kw)


def _random_order(n_valid, n_nodes, seed):
    order = np.arange(n_nodes, dtype=np.int32)
    order[:n_valid] = np.random.default_rng(seed).permutation(n_valid).astype(np.int32)
    return order


@pytest.mark.parametrize("maker", ["rcm_permutation", "degree_sort_permutation"])
def test_orders_match_jax(graphs, maker):
    tg, jg = graphs
    ours = getattr(treorder, maker)(tg)
    np.testing.assert_array_equal(ours, getattr(jreorder, maker)(jg))
    np.testing.assert_array_equal(treorder.inverse_permutation(ours),
                                  jreorder.inverse_permutation(ours))


def test_permute_graph_matches_jax_and_is_equivariant(graphs):
    """The permuted edge arrays equal JAX's; with x_new = x[order] the
    product of the permuted graph is the product's rows in that order,
    through the COO path and the BSR form re-attached after permuting."""
    tg, jg = graphs
    order = _random_order(900, 1024, seed=0)
    ours, ref = treorder.permute_graph(tg, order), jreorder.permute_graph(jg, order)
    for name in ("senders", "receivers", "vals"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)))
    assert ours.bsr is None and ours.senders.dtype == torch.int32
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1024, 16)).astype(np.float32))
    y = spmm_coo(tg, x)
    torch.testing.assert_close(spmm_coo(ours, x[order]), y[order], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(spmm(attach_bsr(ours, device=CPU), x[order], impl="pallas"),
                               y[order], rtol=1e-5, atol=1e-5)
    bad = np.arange(1024)
    bad[0] = 1
    with pytest.raises(ValueError, match="order must permute"):
        treorder.permute_graph(tg, bad)
    moves_tail = np.arange(1024)
    moves_tail[[0, 900]] = moves_tail[[900, 0]]
    with pytest.raises(ValueError, match="order must permute"):
        treorder.permute_graph(tg, moves_tail)


def test_streamed_block_elements_match_jax(graphs):
    tg, jg = graphs
    order = _random_order(900, 1024, seed=7)
    for t, j in ((tg, jg), (treorder.permute_graph(tg, order), jreorder.permute_graph(jg, order))):
        assert treorder.streamed_block_elements(t) == jreorder.streamed_block_elements(j)
    # a shuffle breaks the genomic band: more blocks to stream
    assert (treorder.streamed_block_elements(treorder.permute_graph(tg, order))
            > treorder.streamed_block_elements(tg))


# ---------------------------------------------------------------------------
# torch_port: the original PyTorch checkpoints
# ---------------------------------------------------------------------------


def _state(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _assert_same(ours, oracle, skip=()):
    assert set(ours) - set(skip) == set(oracle) - set(skip)
    for key, value in oracle.items():
        if key not in skip:
            torch.testing.assert_close(ours[key], value, rtol=0, atol=0, msg=key)


def _window(name, tmodel, seq, nclass, **kw):
    """The original window model's state through the port's torch_port, and
    through JAX's torch_port then the port's convert (less the wrapper's
    ``model.`` prefix); the port's model loads the first."""
    state = _state(tmodel)
    ours = getattr(tport, f"port_{name}")(state)
    variables = getattr(jport, f"port_{name}")(state, **kw)
    oracle = window_state_dict({"model": variables["params"]},
                               {"model": variables.get("batch_stats", {})})
    oracle = {k[len("model."):]: v for k, v in oracle.items()}
    model = make_window_model(name, nclass, seq_length=seq)
    model.load_state_dict(ours)
    return state, ours, oracle, model


def test_port_expecto_matches_the_composition():
    seq, nclass = 400, 6
    tmodel = TorchExpecto(nclass, seq).eval()
    with torch.no_grad():
        _randomize_bn_stats(tmodel, np.random.default_rng(0))
    state, ours, oracle, model = _window("expecto", tmodel, seq, nclass,
                                         n_channels=tmodel.n_channels)
    counts = [k for k in ours if k.endswith("num_batches_tracked")]
    _assert_same(ours, oracle, skip=counts)  # the composition resets the counts
    for k in counts:
        theirs = {"bn1": "conv_net.5", "bn2": "conv_net.11", "bn3": "conv_net.17",
                  "head_bn": "batch_norm"}[k.split(".")[0]]
        assert int(ours[k]) == int(state[f"{theirs}.num_batches_tracked"])
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 5, size=(3, seq)))
    model.eval()
    with torch.no_grad():
        feat, logits = model(toks)
        t_feat, t_logits = tmodel(toks)
    torch.testing.assert_close(logits, t_logits, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(feat, t_feat, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["deepsea", "danq"])
def test_port_deepsea_and_danq_match_the_composition(name):
    seq = 400 if name == "deepsea" else 26 + 13 * 5
    nclass = 5
    tmodel = (TorchDeepSEA if name == "deepsea" else TorchDanQ)(nclass, seq).eval()
    kw = {"n_channels": tmodel.n_channels} if name == "deepsea" else {}
    _, ours, oracle, model = _window(name, tmodel, seq, nclass, **kw)
    _assert_same(ours, oracle)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, 5, size=(2, seq)))
    model.eval()
    with torch.no_grad():
        _, logits = model(toks)
        _, t_logits = tmodel(toks)
    torch.testing.assert_close(logits, t_logits, rtol=1e-4, atol=1e-4)


def test_port_chromegcn_and_chromernn_match_the_composition():
    state = jparity.make_chromegcn_state(16, 7, seed=3)
    for layers in (2, 1):
        if layers == 1:
            state = {k: v for k, v in state.items() if not k.startswith(("GC2", "W2"))}
        v = jport.port_chromegcn(state, layers=layers)
        ours = tport.port_chromegcn(state, layers=layers)
        _assert_same(ours, chromegcn_state_dict(v["params"], v["batch_stats"]))
        make_chrome_model("gcn", nclass=7, nfeat=16, layers=layers).load_state_dict(ours)

    n, d, nclass = 30, 16, 7
    tmodel = TorchChromeRNN(d, nclass, 2).eval()
    rng = np.random.default_rng(4)
    with torch.no_grad():
        tmodel.batch_norm.running_mean.copy_(torch.as_tensor(rng.normal(size=d)))
        tmodel.batch_norm.running_var.copy_(torch.as_tensor(rng.uniform(0.5, 2.0, size=d)))
    state = _state(tmodel)
    v = jport.port_chromernn(state, layers=2)
    ours = tport.port_chromernn(state, layers=2)
    _assert_same(ours, chromernn_state_dict(v["params"], v["batch_stats"]))
    model = make_chrome_model("rnn", nclass=nclass, nfeat=d, dropout=0.0)
    model.load_state_dict(ours)
    x = torch.as_tensor(rng.normal(size=(n, d)), dtype=torch.float32)
    with torch.no_grad():
        _, logits, _ = model(x, None, train=False)
        ref = tmodel(x)
    torch.testing.assert_close(logits, ref, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# profiling and the parity harness
# ---------------------------------------------------------------------------


def test_trace_and_block_on(tmp_path):
    with tprofiling.trace(str(tmp_path / "t")) as prof:
        y = torch.ones(64, 64) @ torch.ones(64, 64)
        tprofiling.block_on({"y": [y]})
    assert prof is not None and os.path.getsize(tmp_path / "t" / "trace.json") > 0
    with pytest.raises(TypeError, match="no tensor"):
        tprofiling.block_on([1, 2])


def test_parity_harness_small_scale():
    """The harness on the CPU: the port's model, through the COO path and
    through the BSR form, against the original's computation, layer by
    layer, within the JAX harness test's bound (tests/test_parity_harness.py)."""
    np.testing.assert_array_equal(tparity.make_chromegcn_state(8, 5, seed=1)["out.weight"],
                                  jparity.make_chromegcn_state(8, 5, seed=1)["out.weight"])
    assert tparity.LAYER_ORDER == jparity.LAYER_ORDER
    report = tparity.chromegcn_chr_parity(n_valid=1900, n_pad=2048, n_pairs=6000, d=32,
                                          nclass=21, device=CPU)
    assert set(report) == {"xla", "pallas"}
    for impl, per_layer in report.items():
        assert set(per_layer) == set(tparity.LAYER_ORDER)
        assert max(per_layer.values()) < 2e-4, (impl, per_layer)
    state = tparity.make_chromegcn_state(8, 5, seed=1)
    s, r = np.array([0, 1, 2], np.int32), np.array([1, 2, 0], np.int32)
    v = np.array([0.5, 0.25, 1.0], np.float32)
    x = np.random.default_rng(2).normal(size=(4, 8)).astype(np.float32)
    ours = tparity.torch_chromegcn_oracle(state, s, r, v, 4, x)
    ref = jparity.torch_chromegcn_oracle(state, s, r, v, 4, x)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
