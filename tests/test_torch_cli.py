"""The port's finetune CLI (chromegcn_tpu_torch.main, config, train/runner,
train/checkpoint, utils/metrics + evals, the feature and graph files)
against the JAX package's, on the CPU: the same parser and Config, the same
metrics, checkpoint save/resume/-load_gcn, the modes the port lacks, and a
2-epoch finetune run through both packages' ``main``."""

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
from chromegcn_tpu.train import finetune as jft
from chromegcn_tpu.train.optim import make_optimizer as jax_make_optimizer
from chromegcn_tpu.utils import evals as jevals
from chromegcn_tpu_torch import config as tconfig
from chromegcn_tpu_torch import main as tmain
from chromegcn_tpu_torch.data import artifact as tartifact
from chromegcn_tpu_torch.data import loader as tloader
from chromegcn_tpu_torch.data.synthetic import make_hic_edges
from chromegcn_tpu_torch.models import chrome as tchrome
from chromegcn_tpu_torch.ops import _build
from chromegcn_tpu_torch.ops.gcn_fused import fused_gated_layer
from chromegcn_tpu_torch.train import checkpoint as tckpt
from chromegcn_tpu_torch.train import finetune as tft
from chromegcn_tpu_torch.train import runner as trunner
from chromegcn_tpu_torch.utils import evals as tevals
from chromegcn_tpu_torch.utils.convert import chromegcn_state_dict

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


@pytest.mark.parametrize("extra,item", UNPORTED, ids=lambda v: " ".join(v) if isinstance(v, list) else v)
def test_unported_modes_name_their_roadmap_item(tmp_path, extra, item):
    with pytest.raises(NotImplementedError, match=item):
        tmain.main(_argv(tmp_path, *extra), device=CPU)


@pytest.mark.parametrize("kind", ["orbax", "port"])
def test_stage1_checkpoint_warm_start_raises(tmp_path, kind):
    """The CNN warm start (runner.py:427-434) is not ported; a stage-1
    checkpoint of either package stops the run instead of being skipped."""
    cfg = _write_world(tmp_path)
    if kind == "orbax":
        os.makedirs(os.path.join(cfg.stage1_run_dir, "ckpt"))
    else:
        open(os.path.join(cfg.stage1_run_dir, tckpt.CKPT), "wb").close()
    with pytest.raises(NotImplementedError, match="A10"):
        tmain.main(_argv(tmp_path), device=CPU)


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
