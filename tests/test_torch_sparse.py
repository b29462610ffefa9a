"""Port parity: graph construction and the COO SpMM of chromegcn_tpu_torch
against the JAX package, on the CPU. Host arrays must be equal, not close."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromegcn_tpu.data.synthetic import make_hic_edges as jax_make_hic_edges
from chromegcn_tpu.ops import sparse as jsp
from chromegcn_tpu.ops.spmm import spmm_xla
from chromegcn_tpu_torch.data.synthetic import make_hic_edges
from chromegcn_tpu_torch.ops import sparse as tsp
from chromegcn_tpu_torch.ops.spmm import spmm, spmm_coo

CPU = "cpu"


def _assert_graph_equal(tg, jg):
    for name in ("senders", "receivers", "vals", "node_mask"):
        np.testing.assert_array_equal(
            getattr(tg, name).numpy(), np.asarray(getattr(jg, name)), err_msg=name
        )
    assert tg.n_edges == int(jg.n_edges)
    assert tg.n_nodes == jg.n_nodes
    assert tg.senders.dtype == torch.int32 and tg.vals.dtype == torch.float32


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"hubness": 0.5}, {"compartment_frac": 0.3}, {"hubness": 0.4, "compartment_frac": 0.2}],
)
def test_make_hic_edges_equal(kwargs):
    ours = make_hic_edges(700, 2000, seed=3, **kwargs)
    ref = jax_make_hic_edges(700, 2000, seed=3, **kwargs)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("adj_type", ["constant", "hic", "both", "none"])
def test_build_chrom_graph_equal(adj_type):
    edges = make_hic_edges(1000, 3000, seed=1)
    kw = dict(n_valid=1000, n_pad=1024)
    if adj_type in ("hic", "both"):
        kw["hic_edges"] = edges
    tg = tsp.build_chrom_graph(adj_type, device=CPU, **kw)
    jg = jsp.build_chrom_graph(adj_type, **kw)
    _assert_graph_equal(tg, jg)


def test_build_chrom_graph_options_equal():
    edges = make_hic_edges(300, 900, seed=2)
    kw = dict(n_valid=300, edge_capacity=8192, hic_edges=edges, band=3,
              row_normalize_values=False)
    _assert_graph_equal(
        tsp.build_chrom_graph("both", device=CPU, **kw),
        jsp.build_chrom_graph("both", **kw),
    )


def test_build_chrom_graph_rejects_bad_input():
    with pytest.raises(ValueError):
        tsp.build_chrom_graph("hic", n_valid=10, device=CPU)
    with pytest.raises(ValueError):
        tsp.build_chrom_graph("bogus", n_valid=10, device=CPU)
    with pytest.raises(ValueError):
        tsp.build_chrom_graph("none", n_valid=300, n_pad=256, device=CPU)
    with pytest.raises(ValueError):
        tsp.pad_graph(*tsp.eye_edges(10), n_valid=10, n_pad=16, edge_capacity=4,
                      device=CPU)


def test_coalesce_band_eye_equal():
    rng = np.random.default_rng(0)
    s = rng.integers(0, 50, 400)
    r = rng.integers(0, 50, 400)
    v = rng.random(400).astype(np.float32)
    for a, b in zip(tsp.coalesce_coo(s, r, v, 64), jsp.coalesce_coo(s, r, v, 64)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsp.band_edges(40, 5), jsp.band_edges(40, 5)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsp.eye_edges(9), jsp.eye_edges(9)):
        np.testing.assert_array_equal(a, b)


def test_dense_round_trip_equal():
    rng = np.random.default_rng(4)
    dense = (rng.random((96, 96)) < 0.05) * rng.random((96, 96))
    tg = tsp.from_dense(dense, n_valid=90, device=CPU)
    jg = jsp.from_dense(dense, n_valid=90)
    _assert_graph_equal(tg, jg)
    np.testing.assert_array_equal(tsp.to_dense(tg).numpy(), np.asarray(jsp.to_dense(jg)))
    t = tg.transpose()
    assert torch.equal(t.senders, tg.receivers) and torch.equal(t.receivers, tg.senders)
    assert tg.to(CPU).n_valid_nodes == 90 and tg.edge_capacity == int(jg.edge_capacity)


@pytest.mark.parametrize("d", [32, 128])
def test_spmm_coo_matches_jax(d):
    edges = make_hic_edges(500, 2000, seed=5)
    tg = tsp.build_chrom_graph("hic", n_valid=500, n_pad=512, hic_edges=edges, device=CPU)
    jg = jsp.build_chrom_graph("hic", n_valid=500, n_pad=512, hic_edges=edges)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(512, d)).astype(np.float32)
    ct = rng.normal(size=(512, d)).astype(np.float32)

    xt = torch.tensor(x, requires_grad=True)
    out = spmm_coo(tg, xt)
    (out * torch.from_numpy(ct)).sum().backward()
    ref = spmm_xla(jg, jnp.asarray(x))
    gref = jax.grad(lambda a: jnp.sum(spmm_xla(jg, a) * ct))(jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gref), rtol=1e-5, atol=1e-5)
    # 'auto' without an attached BSR form is the COO path
    np.testing.assert_array_equal(spmm(tg, xt, impl="auto").detach().numpy(),
                                  out.detach().numpy())


def test_row_normalize_binarize_match_jax():
    edges = make_hic_edges(200, 600, seed=8)
    kw = dict(n_valid=200, n_pad=256, hic_edges=edges, row_normalize_values=False)
    tg = tsp.build_chrom_graph("both", device=CPU, **kw)
    jg = jsp.build_chrom_graph("both", **kw)
    for ours, ref in ((tsp.row_normalize(tg), jsp.row_normalize(jg)),
                      (tsp.binarize(tg), jsp.binarize(jg))):
        # row sums of the same float32 values in another order
        np.testing.assert_allclose(ours.vals.numpy(), np.asarray(ref.vals), rtol=1e-6, atol=0)
    # padding rows (zero degree) stay zero; valid rows sum to one
    sums = tsp.to_dense(tsp.row_normalize(tg)).sum(1).numpy()
    np.testing.assert_allclose(sums[:200], 1.0, rtol=1e-6)
    assert not sums[200:].any()


def test_spmm_dispatch_errors():
    g = tsp.build_chrom_graph("none", n_valid=128, device=CPU)
    x = torch.zeros(128, 8)
    with pytest.raises(ValueError, match="attach_bsr"):
        spmm(g, x, impl="pallas")
    with pytest.raises(ValueError, match="unknown spmm impl"):
        spmm(g, x, impl="cusparse")
