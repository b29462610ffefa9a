"""Port parity: the panelled and hybrid operator forms
(chromegcn_tpu_torch.ops.spmm_bsr panels, ops.spmm_hybrid) against the JAX
package's ops/spmm_pallas.py panels and ops/spmm_hybrid.py, on the CPU, with
JAX's Pallas kernel in interpret mode: the host arrays, the products and
their transposes, the cost model, attach_auto's strategies, the model's
route, and a -spmm_form hybrid finetune through both CLIs.

On the CPU every part takes its plain version; chip_smoke.py holds kernel B1
over each form against the same plain versions on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromegcn_tpu import main as jmain
from chromegcn_tpu.models.chrome import make_chrome_model as jax_make_chrome_model
from chromegcn_tpu.ops import sparse as jsp
from chromegcn_tpu.ops import spmm_hybrid as jhy
from chromegcn_tpu.ops import spmm_pallas as jbsr
from chromegcn_tpu.train import finetune as jft
from chromegcn_tpu.train.optim import make_optimizer as jax_make_optimizer
from chromegcn_tpu_torch import main as tmain
from chromegcn_tpu_torch.data.loader import load_chrom_features
from chromegcn_tpu_torch.data.synthetic import make_hic_edges
from chromegcn_tpu_torch.models import chrome as tchrome
from chromegcn_tpu_torch.ops import _build
from chromegcn_tpu_torch.ops import sparse as tsp
from chromegcn_tpu_torch.ops import spmm_bsr as tbsr
from chromegcn_tpu_torch.ops import spmm_hybrid as thy
from chromegcn_tpu_torch.ops.spmm import spmm, spmm_coo
from chromegcn_tpu_torch.train import finetune as tft
from chromegcn_tpu_torch.train import runner as trunner
from chromegcn_tpu_torch.utils.convert import chromegcn_state_dict
from test_torch_cli import NTARGETS, D, _argv, _log, _write_world
from test_torch_spmm_bsr import FIELDS, _as_bits

CPU = "cpu"
# f32 sums of the same products in another order
TOL = dict(rtol=1e-5, atol=1e-5)


def _graphs(kind, n=512):
    """(port graph, JAX graph) from the same arrays: 'band' has a dense
    band (every near-diagonal region clears the threshold), 'sparse' has no
    dense region, 'hic' is a Hi-C graph with both."""
    rng = np.random.default_rng(n)
    if kind == "hic":
        kw = dict(n_valid=n - 40, n_pad=n, hic_edges=make_hic_edges(n - 40, 6 * n, seed=3))
        return tsp.build_chrom_graph("hic", device=CPU, **kw), jsp.build_chrom_graph("hic", **kw)
    density = 0.002 if kind == "sparse" else 0.01
    dense = (rng.random((n, n)) < density) * rng.random((n, n))
    if kind == "band":
        i = np.arange(n)
        for off in range(-40, 41):
            j = np.clip(i + off, 0, n - 1)
            dense[i, j] = rng.random(n) + 0.1
    dense = dense.astype(np.float32)
    return tsp.from_dense(dense, device=CPU), jsp.from_dense(dense)


def _x(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _jax_product_and_grad(product, x, ct):
    """JAX's A @ x and its gradient A^T ct, jitted: the Pallas kernels then
    lower once in interpret mode, not once per call."""
    def both(v, c):
        out, vjp = jax.vjp(product, v)
        return out, vjp(c)[0]

    out, grad = jax.jit(both)(jnp.asarray(x), jnp.asarray(ct))
    return np.asarray(out), np.asarray(grad)


def _equal_matrix(m, r):
    for name in FIELDS:
        np.testing.assert_array_equal(_as_bits(getattr(m, name)), _as_bits(getattr(r, name)),
                                      err_msg=name)
    assert (m.n_rows, m.n_cols, m.tile_r, m.tile_c) == (r.n_rows, r.n_cols, r.tile_r, r.tile_c)


# ---------------------------------------------------------------------------
# panels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["hic", "band"])
@pytest.mark.parametrize("bounds,dtype", [((0, 128, 384, 512), "float32"),
                                          ((0, 256, 512), "bfloat16")])
def test_panel_host_arrays_equal(kind, bounds, dtype):
    """bsr_panels_from_graph(bounds=...) builds JAX's panels: the same
    coordinates and, panel by panel, the same arrays."""
    tg, jg = _graphs(kind)
    ours = tbsr.bsr_panels_from_graph(tg, dtype=dtype, bounds=bounds, device=CPU)
    ref = jbsr.bsr_panels_from_graph(jg, dtype=dtype, bounds=bounds)
    assert ours.bounds == ref.bounds and ours.n_nodes == ref.n_nodes
    for direction in ("fwd", "bwd"):
        assert getattr(ours, f"{direction}_coords") == getattr(ref, f"{direction}_coords")
        for m, r in zip(getattr(ours, direction), getattr(ref, direction)):
            _equal_matrix(m, r)
    assert tbsr.streamed_elements(ours, d=64) == jbsr.streamed_elements(ref, d=64)


@pytest.mark.parametrize("n,d", [(249_856, 128), (50_176, 128), (4096, 1850), (100, 128)])
def test_panel_bounds_match_jax(n, d):
    assert tbsr.panel_bounds(n, d) == jbsr.panel_bounds(n, d)


@pytest.mark.parametrize("kind", ["hic", "upper"])
def test_panel_product_and_transpose_match_jax(kind):
    """A @ x and the gradient A^T g through SpmmBSRPanels against JAX's
    _spmm_bsr_panels custom VJP. 'upper' has edges in rows < 256 only: its
    second row panel holds no live panel and comes out zero, and A^T's
    second column panel is never read. (JAX interprets each panel's kernel
    in ~2 s, so two panels a side.)"""
    bounds = (0, 256, 512)
    if kind == "upper":
        tg, _ = _graphs("band")
        dense = tsp.to_dense(tg).numpy()
        dense[256:] = 0.0
        tg, jg = tsp.from_dense(dense, device=CPU), jsp.from_dense(dense)
    else:
        tg, jg = _graphs(kind)
    ours = tbsr.bsr_panels_from_graph(tg, bounds=bounds, device=CPU)
    ref = jbsr.bsr_panels_from_graph(jg, bounds=bounds)
    x, ct = _x(512, 48, 1), _x(512, 48, 2)
    assert len(ours.fwd) == (2 if kind == "upper" else 4)
    jout, jgrad = _jax_product_and_grad(lambda v: jbsr._spmm_bsr_panels(ref, v), x, ct)
    xt = torch.from_numpy(x).requires_grad_()
    out = tbsr.spmm_bsr_panels(ours, xt)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), **TOL)
    if kind == "upper":
        assert not out[256:].any()


# ---------------------------------------------------------------------------
# the hybrid operator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["band", "sparse", "hic"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_host_arrays_equal(kind, dtype):
    """The straggler lists equal JAX's, padding included; the dense part's
    blocks equal JAX's flat dense part; each edge form is the CSR of its
    list's live entries."""
    tg, jg = _graphs(kind)
    ours = thy.hybrid_from_graph(tg, dtype=dtype, device=CPU)
    ref = jhy.hybrid_from_graph(jg, dtype=dtype)
    for name in ("fs", "fr", "fv", "bs", "br", "bv"):
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (ref.dense is None) == (ours.dense is None) == (kind == "sparse")
    if ref.dense is not None:
        assert isinstance(ref.dense, jbsr.BSROperator)
        for direction in ("fwd", "bwd"):
            _equal_matrix(getattr(ours.dense, direction), getattr(ref.dense, direction))
    e = ours.n_stragglers
    assert e == int((np.asarray(ref.fv) != 0).sum())
    for edges, (s, r, v) in ((ours.fwd_edges, (ours.fs, ours.fr, ours.fv)),
                             (ours.bwd_edges, (ours.bs, ours.br, ours.bv))):
        rows = torch.repeat_interleave(torch.arange(512), edges.row_ptr.diff().long())
        torch.testing.assert_close(rows.int(), r[:e], rtol=0, atol=0)
        torch.testing.assert_close(edges.col, s[:e], rtol=0, atol=0)
        torch.testing.assert_close(edges.val, v[:e], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["band", "sparse", "hic"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_product_and_transpose_match_jax(kind, dtype):
    """A @ x and A^T g through SpmmHybrid against JAX's spmm_hybrid (its
    dense part in interpret mode), at the strand-stacked width 2 x 64."""
    tg, jg = _graphs(kind)
    ours = thy.hybrid_from_graph(tg, dtype=dtype, device=CPU)
    ref = jhy.hybrid_from_graph(jg, dtype=dtype)
    x, ct = _x(512, 128, 3), _x(512, 128, 4)
    jout, jgrad = _jax_product_and_grad(lambda v: jhy.spmm_hybrid(ref, v), x, ct)
    xt = torch.from_numpy(x).requires_grad_()
    out = thy.spmm_hybrid(ours, xt)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), **TOL)


@pytest.mark.parametrize("kind", ["band", "sparse", "hic"])
def test_every_form_through_the_dispatch_equals_coo(kind):
    """spmm(graph, x, 'pallas') routes each attached form (the flat BSR,
    panels, hybrid) to its autograd op; all equal the plain COO product, and
    their gradients the COO path's."""
    tg, _ = _graphs(kind)
    forms = {
        "bsr": tbsr.bsr_from_graph(tg, device=CPU),
        "panels": tbsr.bsr_panels_from_graph(tg, bounds=(0, 256, 512), device=CPU),
        "hybrid": thy.hybrid_from_graph(tg, device=CPU),
    }
    x, ct = torch.from_numpy(_x(512, 32, 5)), torch.from_numpy(_x(512, 32, 6))
    xr = x.clone().requires_grad_()
    (spmm_coo(tg, xr) * ct).sum().backward()
    for name, op in forms.items():
        xo = x.clone().requires_grad_()
        out = spmm(tg.replace(bsr=op), xo, impl="pallas")
        (out * ct).sum().backward()
        torch.testing.assert_close(out, spmm_coo(tg, x), **TOL, msg=name)
        torch.testing.assert_close(xo.grad, xr.grad, **TOL, msg=name)


# ---------------------------------------------------------------------------
# cost models and attach_auto
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["band", "sparse", "hic"])
@pytest.mark.parametrize("d", [128, 64])
def test_estimate_costs_matches_jax(kind, d):
    tg, jg = _graphs(kind)
    assert thy.estimate_costs_ns(tg, d=d) == jhy.estimate_costs_ns(jg, d=d)


def test_estimate_costs_counts_the_forward_orientation_only():
    """The reference's cost model looks at A only (ADVICE.md item 2), and the
    port copies it: on an asymmetric graph it charges the BSR form A's
    blocks, where A^T needs others, and with tiles taller than wide it finds
    regions dense that hybrid_from_graph, which needs both orientations,
    leaves to the stragglers."""
    n = 4096
    dense = np.zeros((n, n), np.float32)
    # 32 groups of 2 rows x 64 columns: one strip each in A; in A^T 64 rows,
    # 8 strips of one region, which the 'auto' split makes a tile
    for g in range(32):
        c = ((g + 5) % 32) * 128
        dense[128 * g:128 * g + 2, c:c + 64] = 1.0
    tg, jg = tsp.from_dense(dense, device=CPU), jsp.from_dense(dense)
    ours = thy.estimate_costs_ns(tg)
    assert ours == jhy.estimate_costs_ns(jg)
    s, r, v = (a.numpy()[:tg.n_edges] for a in (tg.senders, tg.receivers, tg.vals))
    count = dict(tile_r=128, tile_c=128, min_edges_per_tile="auto", dtype=torch.float32,
                 device=torch.device("cpu"), count_only=True)
    fwd = tbsr._build_one_direction(s, r, v, n, **count)[2:]
    bwd = tbsr._build_one_direction(r, s, v, n, **count)[2:]
    assert fwd == (0, 32) and bwd == (32, 0)
    # the forward blocks, at the reference's constants and live-step rounding
    assert ours["bsr_ns"] == 8 * thy._TILE_NS + 32 * thy._STRIP_NS
    # tile 256 x 128: a region of 120 edges over 256 rows of A is dense in A;
    # in A^T its edges fall in two regions of 60
    dense[:] = 0.0
    rng = np.random.default_rng(0)
    for half in (0, 128):
        dense[half + rng.choice(128, 60, replace=False), 128 + rng.choice(128, 60)] = 1.0
    tg, jg = tsp.from_dense(dense, device=CPU), jsp.from_dense(dense)
    ours = thy.estimate_costs_ns(tg, tile=256)
    assert ours == jhy.estimate_costs_ns(jg, tile=256)
    built = thy.hybrid_from_graph(tg, tile=256, device=CPU)
    assert ours["n_dense_tiles"] == 1 and ours["n_straggler_edges"] == 0
    assert built.dense is None and built.n_stragglers == 120 == tg.n_edges


def test_attach_auto_strategies(monkeypatch):
    """'bsr' and 'hybrid' force a form; 'auto' takes the one card_costs_ns
    finds cheaper (the flat form on a tie); an unknown name raises."""
    tg, _ = _graphs("hic")
    assert isinstance(thy.attach_auto(tg, strategy="bsr", device=CPU).bsr, tbsr.BSROperator)
    g = thy.attach_auto(tg, strategy="hybrid", dtype="bfloat16", device=CPU)
    assert isinstance(g.bsr, thy.HybridOperator) and g.bsr.dense.fwd.tiles.dtype == torch.bfloat16
    costs = thy.card_costs_ns(tg)
    want = thy.HybridOperator if costs["hybrid_ns"] < costs["bsr_ns"] else tbsr.BSROperator
    assert isinstance(thy.attach_auto(tg, device=CPU).bsr, want)
    # the choice follows the model: make the hybrid's second launch free
    monkeypatch.setattr(thy, "card_costs_ns", lambda *a, **k: {"bsr_ns": 2.0, "hybrid_ns": 1.0})
    assert isinstance(thy.attach_auto(tg, device=CPU).bsr, thy.HybridOperator)
    monkeypatch.setattr(thy, "card_costs_ns", lambda *a, **k: {"bsr_ns": 1.0, "hybrid_ns": 1.0})
    assert isinstance(thy.attach_auto(tg, device=CPU).bsr, tbsr.BSROperator)
    with pytest.raises(ValueError, match="unknown strategy"):
        thy.attach_auto(tg, strategy="panels", device=CPU)


def test_card_costs_count_the_partition_built():
    """card_costs_ns counts the partition hybrid_from_graph makes, and with
    the card's constants the hybrid (two launches over every row, and the
    add) costs more than the flat form whenever it has a dense part."""
    for kind in ("band", "sparse", "hic"):
        tg, _ = _graphs(kind)
        costs = thy.card_costs_ns(tg)
        built = thy.hybrid_from_graph(tg, device=CPU)
        assert costs["n_straggler_edges"] == built.n_stragglers
        assert costs["n_dense_edges"] == (0 if built.dense is None else built.dense.fwd.nnz)
        if built.dense is not None:
            assert costs["hybrid_ns"] > costs["bsr_ns"]


# ---------------------------------------------------------------------------
# the model and the CLI
# ---------------------------------------------------------------------------


def test_fused_model_takes_the_unfused_path_on_other_forms(monkeypatch):
    """fused='on' runs the fused layer on a flat BSROperator only, as the
    reference's model does: on a panelled or hybrid graph it takes the
    unfused path, through that form, and equals the unfused model."""
    tg, _ = _graphs("hic")
    calls = []
    monkeypatch.setattr(tchrome, "fused_gated_layer",
                        lambda *a: calls.append(1) or pytest.fail("fused layer called"))
    x = torch.from_numpy(_x(512, 16, 7))
    fused = tchrome.make_chrome_model("gcn", nclass=3, nfeat=16, spmm_impl="pallas",
                                      fused="on")
    plain = tchrome.make_chrome_model("gcn", nclass=3, nfeat=16, spmm_impl="xla")
    plain.load_state_dict(fused.state_dict())
    for op in (thy.hybrid_from_graph(tg, device=CPU),
               tbsr.bsr_panels_from_graph(tg, bounds=(0, 256, 512), device=CPU)):
        g = tg.replace(bsr=op)
        assert not fused._use_fused(x, g)
        _, logits, _ = fused(x, g, train=False)
        _, ref, _ = plain(x, g, train=False)
        torch.testing.assert_close(logits, ref, **TOL)
    assert not calls


@pytest.fixture(scope="module")
def jax_hybrid_run(tmp_path_factory):
    """One 2-epoch -load_pretrained -spmm_impl pallas -spmm_form hybrid run
    through the JAX package's main, dropout 0 (its dense parts run the
    Pallas kernel in interpret mode, ~60 s, so the three forms below share
    it): (its config, its initial weights as the port's state_dict)."""
    root = tmp_path_factory.mktemp("jax_hybrid")
    jcfg = _write_world(root, results="jax")
    jmodel = jax_make_chrome_model("gcn", nclass=NTARGETS, dropout=0.0, nfeat=D,
                                   spmm_impl="pallas")
    _, init_rng = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    jstate = jft.create_chrome_state(jmodel, jax_make_optimizer("sgd", 0.25), init_rng, nfeat=D)
    init = chromegcn_state_dict(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))
    attach, forms = jhy.attach_auto, []

    def recording_attach(*a, **k):
        g = attach(*a, **k)
        forms.append(type(g.bsr))
        return g

    jhy.attach_auto = recording_attach
    try:
        jmain.main(_argv(root, "-epochs", "2", "-spmm_impl", "pallas", "-spmm_form", "hybrid",
                         results="jax"))
    finally:
        jhy.attach_auto = attach
    assert forms and set(forms) == {jhy.HybridOperator}
    return jcfg, init


@pytest.mark.parametrize("form,cls", [("hybrid", thy.HybridOperator), ("bsr", tbsr.BSROperator),
                                      ("auto", None)])
def test_spmm_forms_cli_match_jax(tmp_path, monkeypatch, jax_hybrid_run, form, cls):
    """2 epochs of -load_pretrained -spmm_impl pallas -spmm_form {hybrid,
    bsr, auto} through the port's main from JAX's initial weights, dropout
    0, against JAX's -spmm_form hybrid run: the per-epoch losses agree to
    rel 1e-5 and the metrics to 1e-4. Every form computes the same product,
    so one JAX run stands for all three; each port run attaches the form
    asked for ('auto': what attach_auto picks)."""
    jcfg, init = jax_hybrid_run
    tcfg = _write_world(tmp_path, results="port")
    create = tft.create_chrome_state

    def create_from_jax(model, *args, **kwargs):
        state = create(model, *args, **kwargs)
        state.model.load_state_dict(init)
        return state

    monkeypatch.setattr(tft, "create_chrome_state", create_from_jax)
    attached = []
    attach = thy.attach_auto
    monkeypatch.setattr(trunner, "attach_auto",
                        lambda *a, **k: attached.append(attach(*a, **k)) or attached[-1])
    _build.LAUNCHES.clear()
    tmain.main(_argv(tmp_path, "-epochs", "2", "-spmm_impl", "pallas", "-spmm_form", form,
                     results="port"), device=CPU)
    assert not _build.LAUNCHES  # the CPU run takes the plain versions
    if cls is None:  # 'auto': the card's cost model decides, graph by graph
        assert all(type(g.bsr) is type(attach(g.replace(bsr=None), device=CPU).bsr)
                   for g in attached)
    else:
        assert attached and all(isinstance(g.bsr, cls) for g in attached)
    for split in ("train", "valid", "test"):
        ours, ref = _log(tcfg, split), _log(jcfg, split)
        assert ours.shape == ref.shape == (2, 6), split
        np.testing.assert_allclose(ours[:, 1], ref[:, 1], rtol=1e-5, err_msg=f"{split} loss")
        np.testing.assert_allclose(ours[:, 2:], ref[:, 2:], rtol=0, atol=1e-4,
                                   err_msg=f"{split} mAP/meanAUC/meanAUPR/meanFDR")


def test_runner_attaches_the_form_asked_for(tmp_path):
    """build_split_graphs attaches the form -spmm_form names and logs it;
    -spmm_form auto attaches what attach_auto picks."""
    cfg = _write_world(tmp_path)
    feats = load_chrom_features(cfg.feature_path("train"))
    for form, cls, name in (("hybrid", thy.HybridOperator, "the hybrid operator"),
                            ("bsr", tbsr.BSROperator, "the flat BSR form")):
        lines = []
        graphs = trunner.build_split_graphs(
            dataclasses.replace(cfg, spmm_impl="pallas", spmm_form=form), feats, "train",
            device=CPU, verbose=lines.append)
        assert all(isinstance(g.bsr, cls) for g in graphs.values())
        assert lines == [f"train: attached {name} (float32 tiles; -spmm_form {form}) "
                         f"to {len(feats)} chromosome graphs"]
    graphs = trunner.build_split_graphs(dataclasses.replace(cfg, spmm_impl="pallas"), feats,
                                        "train", device=CPU, verbose=lambda *_: None)
    for g in graphs.values():
        want = thy.attach_auto(g.replace(bsr=None), device=CPU).bsr
        assert type(g.bsr) is type(want)
