"""Port parity: the analysis modules (ops/spmm.py:sddmm, analysis/saliency,
utils/metrics.py's per-label metrics and find_optimal_cutoff, pipeline/genome
and variants, analysis/results, utils/summarize, analysis/plots and chord)
against the JAX package's, on the CPU, from the same weights and inputs.

The GCN runs its products through the plain versions here (the BSR form's,
and the COO path where the reference takes it); chip_smoke.py's phase 18
holds the same functions on the card, with kernel B1, to float64.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromegcn_tpu.analysis import results as jresults
from chromegcn_tpu.analysis import saliency as jsal
from chromegcn_tpu.data import loader as jloader
from chromegcn_tpu.models.chrome import ChromeGCN as JaxChromeGCN
from chromegcn_tpu.models.window import make_window_model as jax_make_window_model
from chromegcn_tpu.ops.spmm import sddmm as jax_sddmm
from chromegcn_tpu.pipeline import genome as jgenome
from chromegcn_tpu.pipeline import variants as jvariants
from chromegcn_tpu.train.optim import make_optimizer as jax_make_optimizer
from chromegcn_tpu.train.pretrain import create_window_state as jax_create_window_state
from chromegcn_tpu.utils import metrics as jmetrics
from chromegcn_tpu.utils import summarize as jsummarize
from chromegcn_tpu_torch.analysis import results as tresults
from chromegcn_tpu_torch.analysis import saliency as tsal
from chromegcn_tpu_torch.data import loader as tloader
from chromegcn_tpu_torch.data.constants import SRC_VOCAB
from chromegcn_tpu_torch.data.synthetic import make_window_dataset
from chromegcn_tpu_torch.models.window import make_window_model
from chromegcn_tpu_torch.ops.seq import complement_permutation
from chromegcn_tpu_torch.ops.spmm import sddmm
from chromegcn_tpu_torch.pipeline import genome as tgenome
from chromegcn_tpu_torch.pipeline import variants as tvariants
from chromegcn_tpu_torch.train.pretrain import create_window_state
from chromegcn_tpu_torch.utils import metrics as tmetrics
from chromegcn_tpu_torch.utils import summarize as tsummarize
from chromegcn_tpu_torch.utils.convert import window_state_dict
from test_torch_chrome import D, N, NCLASS, _graphs, _jax_variables, _port_model

CPU = "cpu"
# f32 sums of the same products in another order, relative to each
# output's largest magnitude
SCALED = 1e-5


def _close(ours, ref, tol=SCALED):
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def gcn():
    """(JAX model, its variables, the port's model with the same weights,
    port graph with its BSR form, JAX graph with its, x) on one Hi-C graph."""
    tg, jg = _graphs(bsr=True)
    x = np.random.default_rng(3).normal(size=(N, D)).astype(np.float32)
    jmodel = JaxChromeGCN(nfeat=D, nhid=D, nclass=NCLASS, dropout=0.0, layers=2,
                          spmm_impl="xla")
    params, stats = _jax_variables(jmodel, x, jg)
    variables = {"params": params, "batch_stats": stats}
    return jmodel, variables, _port_model(params, stats, "auto"), tg, jg, x


def test_sddmm_matches_jax(gcn):
    *_, tg, jg, _ = gcn
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(N, 12)).astype(np.float32), rng.normal(size=(N, 12)).astype(np.float32)
    _close(sddmm(tg, torch.as_tensor(a), torch.as_tensor(b)).numpy(),
           jax_sddmm(jg, jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("target", [None, 3])
def test_adjacency_saliency_matches_jax(gcn, target):
    """The gradient with respect to every stored edge value, padding
    included; the port's model keeps its own product setting after."""
    jmodel, variables, model, tg, jg, x = gcn
    ours = tsal.adjacency_saliency(model, x, tg, target)
    _close(ours, jsal.adjacency_saliency(jmodel, variables, jnp.asarray(x), jg, target))
    assert ours.shape == (tg.edge_capacity,) and model.GC1.spmm_impl == "auto"


def test_gates_embeddings_and_feature_saliency_match_jax(gcn):
    """Through the graph's BSR form (the plain version of kernel B1 here)."""
    jmodel, variables, model, tg, jg, x = gcn
    g1, g2 = tsal.gate_values(model, x, tg)
    j1, j2 = jsal.gate_values(jmodel, variables, jnp.asarray(x), jg)
    _close(g1, j1)
    _close(g2, j2)
    _close(tsal.refined_embeddings(model, x, tg),
           jsal.refined_embeddings(jmodel, variables, jnp.asarray(x), jg))
    _close(tsal.feature_saliency(model, x, tg, 5),
           jsal.feature_saliency(jmodel, variables, jnp.asarray(x), jg, 5))


def test_tf_knockout_matrix_matches_jax(gcn):
    jmodel, variables, model, tg, jg, x = gcn
    x_r = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    targets = (np.random.default_rng(5).random((N, NCLASS)) < 0.2).astype(np.float32)
    targets[:, 6] = 0.0  # a label with no positive window
    labels = [0, 2, 6, 4]
    ours = tsal.tf_knockout_matrix(model, x, x_r, tg, targets, labels)
    ref = jsal.tf_knockout_matrix(jmodel, variables, jnp.asarray(x), jnp.asarray(x_r), jg,
                                  targets, labels)
    # relative drops of mean probabilities: f32 differences of numbers ~0.5
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    assert not ours[2].any() and not ours[:, 2].any() and not np.diag(ours).any()


def test_tsne_embeddings_match_jax():
    pytest.importorskip("sklearn")
    emb = np.random.default_rng(6).normal(size=(40, 5)).astype(np.float32)
    np.testing.assert_array_equal(tsal.tsne_embeddings(emb, perplexity=10.0),
                                  jsal.tsne_embeddings(emb, perplexity=10.0))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _label_cases():
    rng = np.random.default_rng(7)
    n, L = 200, 8
    t = (rng.random((n, L)) < 0.3).astype(np.float32)
    t[:, 1] = 0.0   # all negative
    t[:, 2] = 1.0   # all positive
    p = rng.random((n, L)).astype(np.float32)
    p[:, 3] = np.round(p[:, 3], 1)  # heavy ties
    p[:, 4] = 0.5                   # one score
    return t, p


def test_roc_curve_matches_sklearn():
    skm = pytest.importorskip("sklearn.metrics")
    t, p = _label_cases()
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # sklearn warns on a missing class
        for i in range(t.shape[1]):
            for ours, ref in zip(tmetrics.roc_curve(t[:, i], p[:, i]),
                                 skm.roc_curve(t[:, i], p[:, i])):
                np.testing.assert_array_equal(ours, ref)


def _flat(result):
    """A metric's result as a list: mAP is one float, a summary is (mean,
    median, var, all), aupr_and_fdr two summaries."""
    if isinstance(result, float):
        return [result]
    if isinstance(result[0], tuple):
        return [v for summary in result for v in summary]
    return list(result)


@pytest.mark.parametrize("name", ["auroc", "aupr", "fdr", "aupr_and_fdr",
                                  "mean_average_precision"])
def test_label_metrics_match_jax(name):
    t, p = _label_cases()
    ours = _flat(getattr(tmetrics, name)(t, p))
    ref = _flat(getattr(jmetrics, name)(t, p))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=name)


def test_find_optimal_cutoff_matches_jax():
    t, p = _label_cases()
    p[5, 7] = np.nan  # sklearn raises; the reference falls back to 0.5
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jmetrics.find_optimal_cutoff(t, p)
    np.testing.assert_array_equal(tmetrics.find_optimal_cutoff(t, p), ref)
    assert ref[7] == 0.5


# ---------------------------------------------------------------------------
# the variant pipeline
# ---------------------------------------------------------------------------


def _genome(tmp_path):
    rng = np.random.default_rng(8)
    contigs = {"chr1": "".join(rng.choice(list("ACGTN"), 1_333)),
               "chr7": "".join(rng.choice(list("acgt"), 977))}
    path = str(tmp_path / "genome.fa")
    tgenome.write_fasta(path, contigs, line_len=61)
    return path, contigs


def test_fasta_matches_jax(tmp_path):
    path, contigs = _genome(tmp_path)
    jpath = str(tmp_path / "genome_jax.fa")
    jgenome.write_fasta(jpath, contigs, line_len=61)
    assert open(path).read() == open(jpath).read()
    ours, ref = tgenome.Fasta(path), jgenome.Fasta(path)
    assert ours.contigs() == ref.contigs() == {c: len(s) for c, s in contigs.items()}
    for chrom, start, end in (("chr1", 0, 61), ("chr1", 60, 62), ("chr1", 100, 1_400),
                              ("chr7", -5, 40), ("chr7", 976, 977), ("chr7", 500, 500)):
        assert ours.fetch(chrom, start, end) == ref.fetch(chrom, start, end)


def test_variant_sequences_match_jax(tmp_path):
    path, contigs = _genome(tmp_path)
    ours, ref = tgenome.Fasta(path), jgenome.Fasta(path)
    for pos in (3, 200, 900):
        assert tvariants.snp_window(pos, 300) == jvariants.snp_window(pos, 300)
        base = contigs["chr7"][pos]
        alt = "g" if base != "g" else "c"
        for a, b in zip(tvariants.variant_sequences(ours, "chr7", pos, base, alt, 300),
                        jvariants.variant_sequences(ref, "chr7", pos, base, alt, 300)):
            np.testing.assert_array_equal(a, b)
    wrong = "a" if contigs["chr7"][200] != "a" else "c"
    with pytest.raises(ValueError, match="reference mismatch"):
        tvariants.variant_sequences(ours, "chr7", 200, wrong, "t", 300)


def test_score_snp_table_matches_jax(tmp_path):
    """DeepSEA at seq 300 (d_model 8), from JAX's initial weights, eval mode:
    per-label sigmoid(alt) - sigmoid(ref), strand-averaged, in batches."""
    path, contigs = _genome(tmp_path)
    seq, nclass = 300, 5
    jstate = jax_create_window_state(
        jax_make_window_model("deepsea", nclass, seq_length=seq, d_model=8),
        jax_make_optimizer("adam", 1e-3), jax.random.PRNGKey(0), seq, SRC_VOCAB)
    state = create_window_state(make_window_model("deepsea", nclass, seq_length=seq, d_model=8),
                                "adam", 1e-3, device=CPU)
    state.model.load_state_dict(window_state_dict(jax.device_get(jstate.params),
                                                  jax.device_get(jstate.batch_stats)))
    snps = [(c, p, contigs[c][p], "t" if contigs[c][p].lower() != "t" else "a")
            for c, p in (("chr1", 400), ("chr7", 150), ("chr1", 1_000), ("chr7", 700),
                         ("chr1", 10))]
    comp = complement_permutation(SRC_VOCAB)
    ours = tvariants.score_snp_table(state, torch.as_tensor(comp), tgenome.Fasta(path), snps,
                                     batch_size=2, extended=seq)
    ref = jvariants.score_snp_table(jstate, jnp.asarray(comp), jgenome.Fasta(path), snps,
                                    batch_size=2, extended=seq)
    assert ours.shape == (len(snps), nclass)
    # differences of probabilities ~0.5: f32 rounding of each, not of the difference
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    assert state.model.training  # the state's mode is left as it was


# ---------------------------------------------------------------------------
# results, summaries, plots
# ---------------------------------------------------------------------------


def test_per_label_table_matches_jax(tmp_path):
    pytest.importorskip("sklearn")
    t, p = _label_cases()
    p[:, 6] = np.nan  # sklearn raises; both leave the label NaN
    names = [f"label{i}" for i in range(t.shape[1])]
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jresults.per_label_table(p, t, names)
        jresults.write_per_label_csv(str(tmp_path / "jax.csv"), p, t, names)
    ours = tresults.per_label_table(p, t, names)
    for key in ("auroc", "aupr", "fdr"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=0, atol=1e-12, err_msg=key)
    tresults.write_per_label_csv(str(tmp_path / "port.csv"), p, t, names)
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()


def test_compare_runs_and_degree_weights_match_jax(tmp_path):
    rng = np.random.default_rng(9)
    names = [f"wgencodeawgtfbs{i}" if i % 3 == 0 else f"e116-h3k{i}" if i % 3 == 1
             else f"dnase{i}" for i in range(6)]
    for run in ("a", "b"):
        os.makedirs(tmp_path / run / "epochs")
        np.savez(tmp_path / run / "epochs" / "best_metrics.npz",
                 test_preds=rng.random((150, 6)), test_targets=(rng.random((150, 6)) < 0.3))
    ours = tresults.compare_runs(str(tmp_path / "a"), str(tmp_path / "b"), names)
    ref = jresults.compare_runs(str(tmp_path / "a"), str(tmp_path / "b"), names)
    assert ours.keys() == ref.keys()
    for group in ref:
        assert ours[group].keys() == ref[group].keys()
        for key, value in ref[group].items():
            assert ours[group][key] == pytest.approx(value, abs=1e-12), (group, key)
    tg, jg = _graphs(bsr=False)
    targets = [(rng.random((N - 12, 6)) < 0.2).astype(np.float32)]
    targets[0][:, 5] = 0.0  # no positive node: NaN
    ours = tresults.label_degree_weights([tg], targets)
    ref = jresults.label_degree_weights([jg], targets)
    np.testing.assert_allclose(ours, ref, rtol=1e-6)
    assert np.isnan(ours[5])


def test_summarize_data_matches_jax():
    splits = {split: make_window_dataset({"chr1": n}, n_targets=6, seq_length=50, seed=i)
              for i, (split, n) in enumerate((("train", 40), ("valid", 20), ("test", 10)))}
    jsplits = {k: jloader.WindowDataset(**{f: getattr(v, f) for f in (
        "tokens", "targets", "chroms", "starts", "src_vocab", "tgt_vocab")})
        for k, v in splits.items()}
    ours = tsummarize.summarize_data(splits, verbose=lambda *_: None)
    ref = jsummarize.summarize_data(jsplits, verbose=lambda *_: None)
    assert ours.keys() == ref.keys()
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key], value, err_msg=key)
    assert isinstance(splits["train"], tloader.WindowDataset)


def _xy(fig):
    return [line.get_xydata() for line in fig.axes[0].lines]


def test_curve_plots_match_jax():
    """plot_auroc and plot_aupr draw the same curves and legends over the
    port's numpy curves as the JAX package's over sklearn's."""
    pytest.importorskip("matplotlib")
    pytest.importorskip("sklearn")
    from chromegcn_tpu.analysis import plots as jplots
    from chromegcn_tpu_torch.analysis import plots as tplots

    t, p = _label_cases()
    for name in ("plot_auroc", "plot_aupr"):
        ours = getattr(tplots, name)(t, p, label="run")
        ref = getattr(jplots, name)(t, p, label="run")
        for a, b in zip(_xy(ours), _xy(ref)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=name)
        assert ([x.get_label() for x in ours.axes[0].lines]
                == [x.get_label() for x in ref.axes[0].lines]), name


def test_other_plots_and_chord_match_jax(tmp_path, gcn):
    pytest.importorskip("matplotlib")
    from chromegcn_tpu.analysis import chord as jchord
    from chromegcn_tpu.analysis import plots as jplots
    from chromegcn_tpu_torch.analysis import chord as tchord
    from chromegcn_tpu_torch.analysis import plots as tplots

    rng = np.random.default_rng(10)
    a, b = rng.random(9), rng.random(9)
    names = [f"wgencodeawgtfbs{i}" if i % 2 else f"dnase{i}" for i in range(8)] + ["other"]
    figs = [
        (tplots.plot_comparison(a, b), jplots.plot_comparison(a, b)),
        (tplots.plot_label_difference(a, b, names, degree_weights=rng.random(9)),
         jplots.plot_label_difference(a, b, names, degree_weights=rng.random(9))),
        (tplots.violin_plot({"x": a, "y": b}), jplots.violin_plot({"x": a, "y": b})),
    ]
    for ours, ref in figs:
        ax, rx = ours.axes[0], ref.axes[0]
        assert ax.get_title() == rx.get_title() and ax.get_ylabel() == rx.get_ylabel()
        assert len(ax.collections) == len(rx.collections)
    *_, tg, jg, _ = gcn
    edge_values = rng.normal(size=tg.edge_capacity).astype(np.float32)
    ours = tchord.chord_plot(tg, edge_values=edge_values, max_edges=300)
    ref = jchord.chord_plot(jg, edge_values=edge_values, max_edges=300)
    assert len(ours.axes[0].patches) == len(ref.axes[0].patches) > 0
    out = str(tmp_path / "chord.png")
    assert tchord.chord_plot(tg, node_values=rng.random(N), out_path=out) == out
    assert os.path.getsize(out) > 0
