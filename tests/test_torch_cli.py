"""The port's CLI (chromegcn_tpu_torch.main, config, train/runner,
train/checkpoint, utils/metrics + evals, the dataset, feature and graph
files) against the JAX package's, on the CPU: the same parser and Config,
the same metrics, checkpoint save/resume/-load_gcn, the modes the port
lacks, the warm start from stage 1, a 2-epoch finetune run, and the whole
three-mode pipeline (-pretrain, -save_feats, -load_pretrained) through both
packages' ``main``."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from chromegcn_tpu import config as jconfig
from chromegcn_tpu import main as jmain
from chromegcn_tpu.data import artifact as jartifact
from chromegcn_tpu.data import loader as jloader
from chromegcn_tpu.models.chrome import make_chrome_model as jax_make_chrome_model
from chromegcn_tpu.models.window import make_window_model as jax_make_window_model
from chromegcn_tpu.train import finetune as jft
from chromegcn_tpu.train.optim import make_optimizer as jax_make_optimizer
from chromegcn_tpu.train.pretrain import create_window_state as jax_create_window_state
from chromegcn_tpu.utils import evals as jevals
from chromegcn_tpu_torch import config as tconfig
from chromegcn_tpu_torch import main as tmain
from chromegcn_tpu_torch.data import artifact as tartifact
from chromegcn_tpu_torch.data import loader as tloader
from chromegcn_tpu_torch.data.constants import SRC_VOCAB
from chromegcn_tpu_torch.data.synthetic import make_hic_edges, make_window_dataset
from chromegcn_tpu_torch.models import chrome as tchrome
from chromegcn_tpu_torch.models.window import make_window_model
from chromegcn_tpu_torch.ops import _build
from chromegcn_tpu_torch.ops.gcn_fused import fused_gated_layer
from chromegcn_tpu_torch.train import checkpoint as tckpt
from chromegcn_tpu_torch.train import finetune as tft
from chromegcn_tpu_torch.train import pretrain as tpt
from chromegcn_tpu_torch.train import runner as trunner
from chromegcn_tpu_torch.utils import evals as tevals
from chromegcn_tpu_torch.utils.convert import chromegcn_state_dict, window_state_dict
from test_torch_window import jax_no_dropout, no_dropout  # noqa: F401 (a fixture)

CPU = "cpu"
D, NTARGETS = 32, 5
SIZES = {"train": {"chr2": 300, "chr4": 200}, "valid": {"chr3": 250, "chr5": 150},
         "test": {"chr1": 260, "chr6": 180}}


# ---------------------------------------------------------------------------
# parser and Config
# ---------------------------------------------------------------------------

_ACTION_FIELDS = ("option_strings", "dest", "default", "choices", "type", "const",
                  "nargs", "required")


def test_parser_matches_jax():
    """Every flag, its action, choices and default, as the JAX CLI has them."""
    ours = {a.dest: a for a in tmain.build_parser()._actions}
    ref = {a.dest: a for a in jmain.build_parser()._actions}
    assert set(ours) == set(ref)
    for dest, a in ref.items():
        b = ours[dest]
        assert type(a) is type(b), dest
        for field in _ACTION_FIELDS:
            assert getattr(a, field) == getattr(b, field), (dest, field)


ARGVS = [
    [],
    ["-load_pretrained", "-lr2", "0.01", "-lr_decay2", "0.5", "-lr_step_size2", "7",
     "-name2", "x", "-adj_type", "both", "-hicnorm", "KR", "-use_stage2_hparams",
     "-gcn_fused", "on", "-spmm_dtype", "bfloat16"],
    ["-save_feats", "-window_model", "danq", "-lr", "3", "-lr_decay", "0.1",
     "-dropout", "0.25", "-name", "run1", "-small", "-test_batch_size", "0"],
    ["-load_pretrained", "-chrome_model", "rnn", "-no_gate", "-adj_type", "none",
     "-gcn_layers", "1", "-optim", "sgd", "-matmul_precision", "default"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a[:2]) or "defaults")
def test_config_matches_jax(argv):
    """The same fields, values and derived paths from the same command line."""
    assert ([(f.name, f.default) for f in dataclasses.fields(tconfig.Config)]
            == [(f.name, f.default) for f in dataclasses.fields(jconfig.Config)])
    ours = tmain.config_from_args(tmain.build_parser().parse_args(argv))
    ref = jmain.config_from_args(jmain.build_parser().parse_args(argv))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for prop in ("dataset_dir", "data_path", "graph_root", "stage1_id", "experiment_id",
                 "run_dir", "stage1_run_dir"):
        assert getattr(ours, prop) == getattr(ref, prop), prop
    for split in ("train", "valid", "test"):
        assert ours.graph_path(split) == ref.graph_path(split)
        assert ours.feature_path(split) == ref.feature_path(split)
    assert ours.gcn_optim_and_lr() == ref.gcn_optim_and_lr()


# ---------------------------------------------------------------------------
# metrics and the epoch bookkeeping
# ---------------------------------------------------------------------------


def _metric_cases():
    rng = np.random.default_rng(0)
    n, L = 300, 9
    t = (rng.random((n, L)) < 0.2).astype(np.float32)
    t[:, 2] = 0.0  # all-negative label
    t[:, 5] = 1.0  # single-class (all-positive) label
    yield "floats", t, rng.random((n, L)).astype(np.float32)
    yield "ties", t, np.round(rng.random((n, L)), 1).astype(np.float32)
    yield "binary", t, (rng.random((n, L)) < 0.3).astype(np.float32)


@pytest.mark.parametrize("name,t,p", list(_metric_cases()),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_compute_metrics_matches_jax(name, t, p):
    names = [f"wgencodeawgtfbs{i}" if i % 3 == 0 else f"e116-h3k{i}" if i % 3 == 1
             else f"dnase{i}" for i in range(t.shape[1])]
    for per_label_type in (False, True):
        ours = tevals.compute_metrics(p, t, 1.5, 0.25, label_names=names,
                                      per_label_type=per_label_type)
        ref = jevals.compute_metrics(p, t, 1.5, 0.25, label_names=names,
                                     per_label_type=per_label_type)
        assert set(ours) == set(ref)
        for key, value in ref.items():
            np.testing.assert_allclose(ours[key], value, rtol=0, atol=1e-12, err_msg=key)
    assert tevals.selection_score(ours) == jevals.selection_score(ref)


def test_best_tracker_and_logger_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    t = (rng.random((120, 4)) < 0.3).astype(np.float32)
    trackers = (tevals.BestTracker(), jevals.BestTracker())
    loggers = (tevals.EpochLogger(str(tmp_path / "port")),
               jevals.EpochLogger(str(tmp_path / "jax")))
    for epoch in (1, 2, 3):
        v = tevals.compute_metrics(rng.random((120, 4)), t, 1.0 / epoch)
        te = tevals.compute_metrics(rng.random((120, 4)), t, 2.0 / epoch)
        for tracker, logger in zip(trackers, loggers):
            tracker.evaluate(v, te, epoch)
            for split, m in (("valid", v), ("test", te)):
                logger.log(split, epoch, m["loss"], m)
            logger.maybe_snapshot(epoch, v["loss"], tevals.selection_score(v),
                                  None, None, None, None)
    assert trackers[0].summary() == trackers[1].summary()
    assert trackers[0].best_test == trackers[1].best_test
    for name in ("valid.log", "test.log", "train.log", "best.json"):
        assert ((tmp_path / "port" / name).read_text()
                == (tmp_path / "jax" / name).read_text()), name


def test_feature_and_graph_files_interchange(tmp_path):
    """The port reads what the JAX package writes, and the other way round."""
    rng = np.random.default_rng(2)
    arrays = {c: dict(forward=rng.normal(size=(n, 4)).astype(np.float32),
                      backward=rng.normal(size=(n, 4)).astype(np.float32),
                      target=(rng.random((n, 3)) < 0.5).astype(np.float32),
                      starts=np.arange(n, dtype=np.int64) * 1000)
              for c, n in (("chr1", 7), ("chr10", 5))}
    edges = {c: make_hic_edges(50, 80, seed=i) for i, c in enumerate(("chr1", "chr10"))}
    for saver, loader, ours in ((tloader, jloader, True), (jloader, tloader, False)):
        path = str(tmp_path / f"feats_{ours}.npz")
        cls = saver.ChromFeatures
        saver.save_chrom_features(path, {c: cls(**a) for c, a in arrays.items()})
        back = loader.load_chrom_features(path)
        assert set(back) == set(arrays)
        for c, a in arrays.items():
            for field, value in a.items():
                np.testing.assert_array_equal(getattr(back[c], field), value)
    for saver, loader in ((tartifact, jartifact), (jartifact, tartifact)):
        path = str(tmp_path / f"edges_{saver is tartifact}.npz")
        saver.save_graph_edges(path, edges)
        back = loader.load_graph_edges(path)
        assert set(back) == set(edges)
        for c, (s, r, v) in edges.items():
            for got, want in zip(back[c], (s, r, v)):
                np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the finetune run
# ---------------------------------------------------------------------------


def _argv(root, *extra, results="results"):
    return ["-dataroot", str(root / "data"), "-results_dir", str(root / results),
            "-cell_type", "SYN", "-load_pretrained", "-d_model", str(D), "-optim", "sgd",
            "-lr", "0.25", "-adj_type", "hic", "-gcn_dropout", "0", *extra]


def _write_world(root, results="results", seed=0):
    """2 chromosomes per split: saved CNN features and Hi-C edges, written
    with the port's savers where the finetune mode reads them."""
    cfg = tmain.config_from_args(tmain.build_parser().parse_args(_argv(root, results=results)))
    os.makedirs(cfg.stage1_run_dir, exist_ok=True)
    os.makedirs(cfg.graph_root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, (split, chroms) in enumerate(SIZES.items()):
        feats, edges = {}, {}
        for j, (chrom, n) in enumerate(chroms.items()):
            feats[chrom] = tloader.ChromFeatures(
                forward=rng.normal(size=(n, D)).astype(np.float32),
                backward=rng.normal(size=(n, D)).astype(np.float32),
                target=(rng.random((n, NTARGETS)) < 0.2).astype(np.float32),
            )
            edges[chrom] = make_hic_edges(n, 4 * n, seed=10 * i + j)
        tloader.save_chrom_features(cfg.feature_path(split), feats)
        tartifact.save_graph_edges(cfg.graph_path(split), edges)
    return cfg


def _log(cfg, split):
    path = os.path.join(cfg.run_dir, f"{split}.log")
    return np.array([[float(v) for v in line.split(",")]
                     for line in open(path).read().splitlines()]).reshape(-1, 6)


def _quiet(*_):
    pass


def test_checkpoint_save_resume_and_load_gcn(tmp_path):
    """A run stopped after epoch 1 and resumed ends where an uninterrupted
    run ends; -load_gcn restores the saved weights and only evaluates."""
    base = _argv(tmp_path, "-spmm_impl", "pallas", "-gcn_fused", "on")
    cfg = _write_world(tmp_path)
    whole = dataclasses.replace(cfg, epochs=2, name2="whole")
    state_whole, _ = trunner.run(whole, device=CPU, verbose=_quiet)

    tmain.main(base + ["-epochs", "1"], device=CPU)
    saved = tckpt.restore_checkpoint(cfg.run_dir)
    assert saved["epoch"] == 1 and set(saved) == {"model", "optimizer", "epoch", "score"}
    assert not os.path.exists(os.path.join(cfg.run_dir, "ckpt"))  # no orbax directory
    tmain.main(base + ["-epochs", "2", "-resume"], device=CPU)
    resumed = tckpt.restore_checkpoint(cfg.run_dir)
    ref = tckpt.restore_checkpoint(whole.run_dir)
    np.testing.assert_allclose(_log(cfg, "train"), _log(whole, "train"), rtol=1e-6)
    assert resumed["epoch"] == ref["epoch"] and resumed["score"] == pytest.approx(ref["score"])
    for name, value in ref["model"].items():
        torch.testing.assert_close(resumed["model"][name], value, rtol=1e-6, atol=1e-6)
    for i, value in ref["optimizer"]["state"].items():  # SGD momentum buffers
        torch.testing.assert_close(resumed["optimizer"]["state"][i]["momentum_buffer"],
                                   value["momentum_buffer"], rtol=1e-6, atol=1e-6)
    if ref["epoch"] == 2:
        for name, value in state_whole.model.state_dict().items():
            torch.testing.assert_close(ref["model"][name], value)

    test_log = _log(cfg, "test")
    epoch = resumed["epoch"]
    tmain.main(base + ["-epochs", "1", "-load_gcn"], device=CPU)
    assert _log(cfg, "train").size == 0 and _log(cfg, "valid").size == 0
    np.testing.assert_allclose(_log(cfg, "test")[0, 1:], test_log[epoch - 1, 1:], rtol=1e-6)

    all_mode = dataclasses.replace(cfg, epochs=1, save_mode="all", name2="all")
    trunner.run(all_mode, device=CPU, verbose=_quiet)
    names = [n for n in os.listdir(all_mode.run_dir) if n.startswith("ckpt")]
    assert len(names) == 1 and names[0].startswith("ckpt_epoch1_score") and names[0].endswith(".pt")


UNPORTED = [
    (["-pretrain"], "A10"),
    (["-save_feats"], "A10"),
    (["-joint"], "A11"),
    (["-chrome_model", "rnn"], "A12"),
    (["-graph_devices", "2"], "A13"),
    (["-dp_devices", "2"], "A13"),
    (["-tp_devices", "4"], "A13"),
    (["-spmm_form", "hybrid"], "A9"),
]
# ROADMAP items that have landed: their modes run through the port
PORTED = {"A10"}


def _window_argv(root, *extra):
    return ["-dataroot", str(root / "data"), "-results_dir", str(root / "results"),
            "-cell_type", "SYN", "-seq_length", "400", "-batch_size", "8", "-d_model", "8",
            *extra]


def _write_window_world(root):
    """The dataset file of a tiny window world, written with the port's saver."""
    cfg = tmain.config_from_args(tmain.build_parser().parse_args(_window_argv(root)))
    os.makedirs(cfg.dataset_dir, exist_ok=True)
    tartifact.save_dataset(cfg.data_path, {
        split: make_window_dataset({chrom: 10}, n_targets=3, seq_length=400, seed=i)
        for i, (split, chrom) in enumerate((("train", "chr2"), ("valid", "chr3"),
                                            ("test", "chr1")))})
    return cfg


@pytest.mark.parametrize("extra,item", UNPORTED, ids=lambda v: " ".join(v) if isinstance(v, list) else v)
def test_unported_modes_name_their_roadmap_item(tmp_path, extra, item):
    """A mode the port lacks raises NotImplementedError naming its ROADMAP
    item. A10 has landed: -pretrain trains and checkpoints the window CNN,
    and -save_feats, which stops without a stage-1 checkpoint, then dumps
    every split's features."""
    if item not in PORTED:
        with pytest.raises(NotImplementedError, match=item):
            tmain.main(_argv(tmp_path, *extra), device=CPU)
        return
    cfg = _write_window_world(tmp_path)
    argv = _window_argv(tmp_path, *extra)
    if extra == ["-save_feats"]:
        with pytest.raises(FileNotFoundError, match="save_feats requires a trained window"):
            tmain.main(argv, device=CPU)
        tmain.main(_window_argv(tmp_path, "-pretrain", "-epochs", "1"), device=CPU)
        tmain.main(argv, device=CPU)
        for split, chrom in (("train", "chr2"), ("valid", "chr3"), ("test", "chr1")):
            feats = tloader.load_chrom_features(cfg.feature_path(split))
            assert list(feats) == [chrom] and feats[chrom].forward.shape == (10, 8)
    else:
        tmain.main(argv + ["-epochs", "1"], device=CPU)
        assert set(tckpt.restore_checkpoint(cfg.stage1_run_dir)) == {
            "model", "optimizer", "epoch", "score"}
        assert _log(dataclasses.replace(cfg, load_pretrained=False), "train").shape == (1, 6)


@pytest.mark.parametrize("kind", ["orbax", "port"])
def test_stage1_checkpoint_warm_start_raises(tmp_path, kind, capsys):
    """A stage-1 checkpoint warm-starts the GCN head (runner.py:427-434). The
    port's own ``ckpt.pt`` does: the GCN's out and batch_norm start as the
    window model's classifier and head_bn. The JAX package's orbax
    directory cannot be read without jax, and stops the run instead of
    being skipped."""
    cfg = _write_world(tmp_path)
    if kind == "orbax":
        os.makedirs(os.path.join(cfg.stage1_run_dir, "ckpt"))
        with pytest.raises(NotImplementedError, match="orbax checkpoint"):
            tmain.main(_argv(tmp_path), device=CPU)
        return
    wstate = tpt.create_window_state(make_window_model("expecto", NTARGETS, d_model=D),
                                     seed=3, device=CPU)
    with torch.no_grad():
        wstate.model.model.head_bn.running_mean.normal_(generator=torch.Generator().manual_seed(0))
    tckpt.save_checkpoint(cfg.stage1_run_dir, wstate, epoch=1)
    state, _ = trunner.run(dataclasses.replace(cfg, epochs=0), device=CPU)
    assert "warm-started GCN head from CNN checkpoint" in capsys.readouterr().out
    window = wstate.model.model
    for got, want in ((state.model.out.weight, window.classifier.weight),
                      (state.model.out.bias, window.classifier.bias),
                      (state.model.batch_norm.weight, window.head_bn.weight),
                      (state.model.batch_norm.running_mean, window.head_bn.running_mean),
                      (state.model.batch_norm.running_var, window.head_bn.running_var)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_runner_forms_and_precision(tmp_path):
    cfg = _write_world(tmp_path)
    feats = tloader.load_chrom_features(cfg.feature_path("train"))
    lines = []
    auto = trunner.build_split_graphs(cfg, feats, "train", CPU, verbose=lines.append)
    assert all(g.bsr is None for g in auto.values()) and not lines  # 'auto' on the CPU
    bsr = trunner.build_split_graphs(dataclasses.replace(cfg, spmm_impl="pallas"), feats,
                                     "train", CPU, verbose=lines.append)
    assert all(g.bsr is not None and g.n_nodes == 2048 for g in bsr.values())
    assert lines == ["train: attached the flat BSR form (float32 tiles; -spmm_form auto) "
                     "to 2 chromosome graphs"]
    try:
        for precision, allow in (("default", True), ("high", False), ("highest", False)):
            trunner.apply_matmul_precision(dataclasses.replace(cfg, matmul_precision=precision))
            assert torch.backends.cuda.matmul.allow_tf32 is allow
            assert torch.backends.cudnn.allow_tf32 is allow
            assert torch.backends.cudnn.enabled is allow
    finally:
        trunner.apply_matmul_precision(cfg)
    with pytest.raises(trunner.NonFiniteLossError):
        trunner._check_finite(float("nan"), "epoch 1")


def test_finetune_cli_matches_jax(tmp_path, monkeypatch):
    """2 epochs through the JAX package's main and the port's, from the same
    initial weights (split(PRNGKey(seed)) as runner.py:390-392 draws them),
    dropout 0: the per-epoch losses agree to rel 1e-5 and the metrics to
    1e-4. The port runs -spmm_impl pallas -spmm_form bsr -gcn_fused on. The
    JAX side runs -spmm_impl xla: its fused kernels in interpret mode take
    over 60 s for this run on the CPU, and its fused layer is exact against
    its unfused one (tests/test_fused.py; tests/test_torch_fused.py holds the
    port's fused model and train steps against JAX's fused ones)."""
    fused = ["-epochs", "2", "-spmm_form", "bsr", "-gcn_fused", "on"]
    jcfg = _write_world(tmp_path, results="jax")
    tcfg = _write_world(tmp_path, results="port")

    # the JAX run's initial state, carried into the port's state creation
    jmodel = jax_make_chrome_model("gcn", nclass=NTARGETS, dropout=0.0, nfeat=D,
                                   spmm_impl="xla", fused="on")
    _, init_rng = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    jstate = jft.create_chrome_state(jmodel, jax_make_optimizer("sgd", 0.25), init_rng, nfeat=D)
    init = chromegcn_state_dict(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))
    create = tft.create_chrome_state

    def create_from_jax(model, *args, **kwargs):
        state = create(model, *args, **kwargs)
        state.model.load_state_dict(init)
        return state

    monkeypatch.setattr(tft, "create_chrome_state", create_from_jax)
    jmain.main(_argv(tmp_path, *fused, "-spmm_impl", "xla", results="jax"))
    _build.LAUNCHES.clear()
    layers = []
    monkeypatch.setattr(tchrome, "fused_gated_layer",
                        lambda *a: layers.append(1) or fused_gated_layer(*a))
    tmain.main(_argv(tmp_path, *fused, "-spmm_impl", "pallas", results="port"), device=CPU)
    assert not _build.LAUNCHES  # the CPU run takes the kernels' plain versions
    # 2 epochs x (2 train chromosomes x 2 strands x 2 layers + 4 eval chromosomes x 4)
    assert len(layers) == 2 * (2 * 4 + 4 * 4)
    for split in ("train", "valid", "test"):
        ours, ref = _log(tcfg, split), _log(jcfg, split)
        assert ours.shape == ref.shape == (2, 6), split
        np.testing.assert_allclose(ours[:, 1], ref[:, 1], rtol=1e-5, err_msg=f"{split} loss")
        np.testing.assert_allclose(ours[:, 2:], ref[:, 2:], rtol=0, atol=1e-4,
                                   err_msg=f"{split} mAP/meanAUC/meanAUPR/meanFDR")


# ---------------------------------------------------------------------------
# the three-mode pipeline
# ---------------------------------------------------------------------------


def test_pipeline_cli_matches_jax(tmp_path, monkeypatch, capsys, jax_no_dropout):
    """The JAX CLI's world (tests/test_cli.py:68-88: seq 400, 4 targets,
    batch 8, -d_model 16, -adj_type constant, Adam) through both packages'
    ``main``: -pretrain -epochs 2, -save_feats, then -load_pretrained
    -epochs 2 -gcn_dropout 0.0, warm-started from stage 1. Both start from
    JAX's initial weights (split(PRNGKey(seed)) as runner.py:72-73 and
    :390-392 draw them), with dropout out and no shuffle. Per-epoch losses
    agree to rel 1e-4, the metrics to 1e-4 and the saved features to 1e-4;
    the logs have the same shape, the two pretrain rows surviving
    -save_feats.

    lr is 1e-6, not test_cli.py's 1e-3. At 1e-3 (or SGD at 1e-3) this
    40-window world trains chaotically, and the two frameworks' f32
    rounding drifts their losses apart by ~1e-2 within 3 steps. At 1e-5 the
    losses stay within ~3e-6, but Adam moves each weight whose gradient is
    at rounding level by ~lr either way, and after 10 steps the conv biases
    of near-dead channels move the saved features by ~1.2e-4 of their
    scale (~5e-5 at 1e-6, ~1e-6 before any step). test_torch_pretrain.py
    holds each step to JAX's at Adam lr 1e-3."""
    dataroot = tmp_path / "data"
    splits = {
        "train": make_window_dataset({"chr2": 24, "chr4": 16}, n_targets=4, seq_length=400, seed=0),
        "valid": make_window_dataset({"chr3": 16}, n_targets=4, seq_length=400, seed=1),
        "test": make_window_dataset({"chr1": 16}, n_targets=4, seq_length=400, seed=2),
    }
    os.makedirs(dataroot / "SYN" / "1000")
    tartifact.save_dataset(str(dataroot / "SYN" / "1000" / "dataset.npz"), splits)

    def argv(results, *extra):
        return ["-dataroot", str(dataroot), "-results_dir", str(tmp_path / results),
                "-cell_type", "SYN", "-batch_size", "8", "-seq_length", "400", "-d_model", "16",
                "-optim", "adam", "-lr", "1e-06", "-adj_type", "constant", *extra]

    # the JAX runs' initial states, carried into the port's state creation
    _, init_rng = jax.random.split(jax.random.PRNGKey(0))
    jw = jax_create_window_state(jax_make_window_model("expecto", 4, seq_length=400, d_model=16),
                                 jax_make_optimizer("adam", 1e-6), init_rng, 400, dict(SRC_VOCAB))
    window_init = window_state_dict(jax.device_get(jw.params), jax.device_get(jw.batch_stats))
    jc = jft.create_chrome_state(jax_make_chrome_model("gcn", nclass=4, dropout=0.0, nfeat=16),
                                 jax_make_optimizer("adam", 1e-6), init_rng, nfeat=16)
    chrome_init = chromegcn_state_dict(jax.device_get(jc.params), jax.device_get(jc.batch_stats))
    create_window, create_chrome = tpt.create_window_state, tft.create_chrome_state

    def window_from_jax(model, *args, **kwargs):
        state = create_window(model, *args, **kwargs)
        state.model.load_state_dict(window_init)
        no_dropout(state.model)
        return state

    def chrome_from_jax(model, *args, **kwargs):
        state = create_chrome(model, *args, **kwargs)
        state.model.load_state_dict(chrome_init)
        return state

    monkeypatch.setattr(tpt, "create_window_state", window_from_jax)
    monkeypatch.setattr(tft, "create_chrome_state", chrome_from_jax)
    modes = (["-pretrain", "-epochs", "2"], ["-save_feats"],
             ["-load_pretrained", "-epochs", "2", "-gcn_dropout", "0.0"])
    for extra in modes:
        jmain.main(argv("jax", *extra))
        tmain.main(argv("port", *extra), device=CPU)
    out = capsys.readouterr().out
    assert out.count("warm-started GCN head from CNN checkpoint") == 2  # both packages

    def cfg(results, *extra):
        return tmain.config_from_args(tmain.build_parser().parse_args(argv(results, *extra)))

    for stage_extra in ((), modes[2]):
        ours_cfg, ref_cfg = cfg("port", *stage_extra), cfg("jax", *stage_extra)
        for split in ("train", "valid", "test"):
            ours, ref = _log(ours_cfg, split), _log(ref_cfg, split)
            assert ours.shape == ref.shape == (2, 6), (stage_extra, split)
            np.testing.assert_allclose(ours[:, 1], ref[:, 1], rtol=1e-4,
                                       err_msg=f"{stage_extra} {split} loss")
            np.testing.assert_allclose(ours[:, 2:], ref[:, 2:], rtol=0, atol=1e-4,
                                       err_msg=f"{stage_extra} {split} metrics")
    assert tckpt.checkpoint_exists(cfg("port").stage1_run_dir)
    for split in ("train", "valid", "test"):
        ours = tloader.load_chrom_features(cfg("port").feature_path(split))
        ref = jloader.load_chrom_features(cfg("jax").feature_path(split))
        assert list(ours) == list(ref)
        for chrom, cf in ref.items():
            for field in ("forward", "backward"):
                want = getattr(cf, field)
                err = np.abs(getattr(ours[chrom], field) - want).max()
                assert err <= 1e-4 * np.abs(want).max(), (split, chrom, field, err)
            np.testing.assert_array_equal(ours[chrom].target, cf.target)
            np.testing.assert_array_equal(ours[chrom].starts, cf.starts)
