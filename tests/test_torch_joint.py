"""The port's joint CNN+GCN training (train/joint.py, run_joint in
train/runner.py, the joint checkpoint, EpochLogger.log_loss, the
graph-coupled synthetic world) against the JAX package's, on the CPU:
two joint steps and an eval step from the same weights (tests/test_joint.py's
shapes: seq 400, d 8, 16 windows, chunks of 8, GCN dropout 0), chunked
against unchunked, the datasets equal from one seed, resume, the warm start
and the flags joint mode refuses.

The two train steps run DeepSEA: a JAX joint step through Expecto takes
~14 s on the CPU (DeepSEA's ~1.6 s). Expecto's eval step is held to JAX's,
and its train step to the unchunked one, here and on the card
(chip_smoke.py)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromegcn_tpu.data import synthetic as jsynthetic
from chromegcn_tpu.data.constants import SRC_VOCAB
from chromegcn_tpu.models.chrome import ChromeGCN as JaxChromeGCN
from chromegcn_tpu.models.strand import NonStrandSpecific as JaxNonStrandSpecific
from chromegcn_tpu.ops import sparse as jsp
from chromegcn_tpu.train import finetune as jft
from chromegcn_tpu.train import joint as jjoint
from chromegcn_tpu.train import pretrain as jpt
from chromegcn_tpu.train.optim import make_optimizer as jax_make_optimizer
from chromegcn_tpu.utils import evals as jevals
from chromegcn_tpu_torch import main as tmain
from chromegcn_tpu_torch.config import Config
from chromegcn_tpu_torch.data import artifact as tartifact
from chromegcn_tpu_torch.data import synthetic as tsynthetic
from chromegcn_tpu_torch.models.chrome import ChromeGCN, make_chrome_model
from chromegcn_tpu_torch.models.window import make_window_model
from chromegcn_tpu_torch.ops import sparse as tsp
from chromegcn_tpu_torch.ops.seq import complement_permutation
from chromegcn_tpu_torch.train import checkpoint as tckpt
from chromegcn_tpu_torch.train import finetune as tft
from chromegcn_tpu_torch.train import joint as tjoint
from chromegcn_tpu_torch.train import pretrain as tpt
from chromegcn_tpu_torch.train import runner as trunner
from chromegcn_tpu_torch.train.optim import make_optimizer
from chromegcn_tpu_torch.utils import evals as tevals
from chromegcn_tpu_torch.utils.convert import chromegcn_state_dict, window_state_dict
from test_torch_rnn import torch_one_thread  # noqa: F401 (a fixture)
from test_torch_window import NTARGETS, SEQ, jax_window_state, port_model
import torch_parallel_workers as workers

# torch on one thread: the test workers share the cores, and torch's CPU
# convolutions and LSTMs slow down ~20x when every worker runs a full pool
pytestmark = pytest.mark.usefixtures("torch_one_thread")

CPU = "cpu"
D, N_VALID, N_PAD, CHUNK, LR = 8, 14, 16, 8, 1e-3
# the window stage's tolerance (tests/test_torch_window.py): f32 sums of
# ~10^4 products each, in another order; 1e-4 of each tensor's scale
REL = 1e-4


def _close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-12), (what, err, np.abs(want).max())


def _world(seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 4, size=(N_PAD, SEQ)).astype(np.int32)
    targets = (rng.random((N_PAD, NTARGETS)) < 0.3).astype(np.float32)
    return tokens, targets


def _states(name="expecto", optim="adam", lr=LR):
    """JAX's and the port's (window, chrome) states from the same weights:
    the window model with its BatchNorms (if any) off their identity values,
    the 2-layer GCN from JAX's init."""
    jmodel, params, stats = jax_window_state(name, seed=5, d_model=D)
    jw = jpt.WindowTrainState.create(
        apply_fn=JaxNonStrandSpecific(model=jmodel).apply,
        params=jax.tree_util.tree_map(jnp.asarray, params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats), tx=jax_make_optimizer(optim, lr))
    jc = jft.create_chrome_state(JaxChromeGCN(nfeat=D, nhid=D, nclass=NTARGETS, dropout=0.0),
                                 jax_make_optimizer(optim, lr), jax.random.PRNGKey(1), nfeat=D)
    wmodel = port_model(name, params, stats, d_model=D)
    cmodel = ChromeGCN(nfeat=D, nhid=D, nclass=NTARGETS, dropout=0.0)
    cmodel.load_state_dict(chromegcn_state_dict(jax.device_get(jc.params),
                                                jax.device_get(jc.batch_stats)))
    tw = tpt.WindowTrainState(wmodel, make_optimizer(optim, lr, wmodel.parameters()))
    tc = tft.ChromeTrainState(cmodel, make_optimizer(optim, lr, cmodel.parameters()))
    return (jw, jc), (tw, tc)


def _graphs():
    return (tsp.build_chrom_graph("constant", n_valid=N_VALID, n_pad=N_PAD, device=CPU),
            jsp.build_chrom_graph("constant", n_valid=N_VALID, n_pad=N_PAD))


def _comp():
    return complement_permutation(SRC_VOCAB)


def test_two_joint_steps_match_jax():
    """Two joint_train_steps (DeepSEA and the GCN, SGD lr 0.05 with
    momentum, both stages): each step's loss, then both models' parameters,
    the momentum buffers and the chrome model's BatchNorm statistics
    (updated per strand) agree to 1e-4 of their scale. SGD, not Adam: Adam's
    first update is lr sign(g), which moves a weight whose gradient is at
    rounding level by lr either way in either framework."""
    (jw, jc), (tw, tc) = _states("deepsea", "sgd", 0.05)
    tg, jg = _graphs()
    tokens, targets = _world()
    comp = _comp()
    for step in range(2):
        jw, jc, jloss = jjoint.joint_train_step(
            jw, jc, jnp.asarray(tokens), jnp.asarray(comp), jg, jnp.asarray(targets),
            jax.random.PRNGKey(step), chunk_size=CHUNK)
        tw, tc, loss = tjoint.joint_train_step(tw, tc, tokens, torch.as_tensor(comp), tg,
                                               targets, chunk_size=CHUNK, device=CPU)
        _close(loss.item(), float(jloss), f"step {step} loss", rel=1e-5)
    assert tw.step == tc.step == 2
    for state, jstate, convert in ((tw, jw, window_state_dict), (tc, jc, chromegcn_state_dict)):
        stats = jax.device_get(jstate.batch_stats)
        ref = convert(jax.device_get(jstate.params), stats)
        trace = convert(jax.device_get(jstate.opt_state.inner_state[1].trace), stats)
        names = [k for k, _ in state.model.named_parameters()]
        moments = state.optimizer.state_dict()["state"]
        for key, value in state.model.state_dict().items():
            _close(value.numpy(), ref[key].numpy(), key)
            if key not in names:
                continue
            if names.index(key) in moments:
                _close(moments[names.index(key)]["momentum_buffer"].numpy(),
                       trace[key].numpy(), f"{key} momentum")
            else:
                # the window classifier's logits are not in the joint loss:
                # torch leaves it without a gradient, JAX's trace holds only
                # its weight decay (1e-6 p)
                assert key.startswith("model.classifier"), key


def test_joint_eval_step_matches_jax():
    (jw, jc), (tw, tc) = _states()
    tg, jg = _graphs()
    tokens, targets = _world(1)
    comp = _comp()
    jloss, jprobs = jjoint.joint_eval_step(jw, jc, jnp.asarray(tokens), jnp.asarray(comp), jg,
                                           jnp.asarray(targets), chunk_size=CHUNK)
    loss, probs = tjoint.joint_eval_step(tw, tc, tokens, torch.as_tensor(comp), tg, targets,
                                         chunk_size=CHUNK, device=CPU)
    _close(loss.item(), float(jloss), "loss", rel=1e-5)
    assert probs.shape == (N_PAD, NTARGETS)
    _close(probs.numpy(), jprobs, "probs")


@pytest.mark.parametrize("chrome", ["gcn", "rnn"])
def test_chunked_matches_unchunked(chrome):
    """Chunks of 8 under checkpoint, against one call over all 16 windows
    with nothing recomputed: the same loss and gradients of both models.
    Then a joint_train_step trains the CNN (Expecto) and leaves its
    BatchNorm statistics as they were: the CNN runs in eval mode."""
    grads = {}
    for chunk, remat in ((CHUNK, True), (N_PAD, False)):
        torch.manual_seed(0)
        wmodel = tpt.NonStrandSpecific(make_window_model("expecto", NTARGETS, SEQ, D))
        cmodel = make_chrome_model(chrome, nclass=NTARGETS, dropout=0.0, nfeat=D)
        tw = tpt.WindowTrainState(wmodel, make_optimizer("adam", LR, wmodel.parameters()))
        tc = tft.ChromeTrainState(cmodel, make_optimizer("adam", LR, cmodel.parameters()))
        tg, _ = _graphs()
        tokens, targets = _world(2)
        loss, _ = tjoint.joint_loss(tw, tc, torch.as_tensor(tokens),
                                    torch.as_tensor(_comp()), tg, torch.as_tensor(targets),
                                    chunk_size=chunk, remat=remat)
        loss.backward()
        grads[chunk] = (loss.item(), {
            f"{name}.{k}": p.grad.clone() for name, m in (("w", wmodel), ("c", cmodel))
            for k, p in m.named_parameters() if p.grad is not None})
    (loss_c, g_c), (loss_u, g_u) = grads[CHUNK], grads[N_PAD]
    assert abs(loss_c - loss_u) <= 1e-6 * abs(loss_u)
    assert set(g_c) == set(g_u)
    for key, want in g_u.items():
        _close(g_c[key].numpy(), want.numpy(), key, rel=1e-5)
    before = {k: v.clone() for k, v in tw.model.state_dict().items()}
    tjoint.joint_train_step(tw, tc, tokens, torch.as_tensor(_comp()), tg, targets,
                            chunk_size=CHUNK, device=CPU)
    for key, value in tw.model.state_dict().items():
        if "running" in key:
            torch.testing.assert_close(value, before[key], rtol=0, atol=0)
        elif key.startswith("model.conv"):
            assert not torch.equal(value, before[key]), key
    with pytest.raises(ValueError, match="multiple of chunk_size"):
        tjoint._cnn_features(wmodel, torch.as_tensor(tokens[:12]), torch.as_tensor(_comp()),
                             CHUNK, tg)
    with pytest.raises(TypeError, match="SparseGraph or a ShardedGraph"):
        tjoint._cnn_features(wmodel, torch.as_tensor(tokens), torch.as_tensor(_comp()),
                             CHUNK, object())


@pytest.mark.parametrize("kwargs", [
    {},
    {"neighbor_only_frac": 0.25, "hubness": 0.5},
    {"degree_coupled_frac": 0.5, "compartment_frac": 0.3},
], ids=["plain", "neighbor_only_hubs", "degree_coupled"])
def test_graph_coupled_dataset_matches_jax(kwargs):
    """Equal arrays, bit for bit, from one seed: the rng stream is the
    reference's."""
    split_chroms = {"train": {"chr2": 60, "chr4": 40}, "valid": {"chr3": 30}}
    args = dict(n_targets=11, seq_length=200, n_motifs=8, seed=3, **kwargs)
    ours, ours_g = tsynthetic.make_graph_coupled_dataset(split_chroms, **args)
    ref, ref_g = jsynthetic.make_graph_coupled_dataset(split_chroms, **args)
    assert list(ours) == list(ref)
    for split, ds in ref.items():
        for field in ("tokens", "targets", "chroms", "starts"):
            np.testing.assert_array_equal(getattr(ours[split], field), getattr(ds, field))
        assert ours[split].tgt_vocab == ds.tgt_vocab and ours[split].src_vocab == ds.src_vocab
        assert list(ours_g[split]) == list(ref_g[split])
        for chrom, arrays in ref_g[split].items():
            for got, want in zip(ours_g[split][chrom], arrays):
                np.testing.assert_array_equal(got, want)
    assert ours["train"].targets.any()
    for a, b in zip(tsynthetic.graph_coupled_motifs(np.random.default_rng(7), 8, 6, 11),
                    jsynthetic.graph_coupled_motifs(np.random.default_rng(7), 8, 6, 11)):
        np.testing.assert_array_equal(a, b)


def test_log_loss_matches_jax(tmp_path):
    loggers = (tevals.EpochLogger(str(tmp_path / "port")),
               jevals.EpochLogger(str(tmp_path / "jax")))
    for logger in loggers:
        logger.log_loss("train", 1, 0.6931471805599453)
        logger.log_loss("train", 2, 0.5)
    text = (tmp_path / "port" / "train.log").read_text()
    assert text == (tmp_path / "jax" / "train.log").read_text()
    assert text.splitlines()[0] == "1,0.6931471805599453,nan,nan,nan,nan"


# ---------------------------------------------------------------------------
# run_joint: resume, the warm start, refused flags
# ---------------------------------------------------------------------------


def _cfg(root, **kw):
    """A tiny joint world: DeepSEA at seq 200 (the cheapest window CNN on the
    CPU; Expecto needs seq 400), one 10-window chromosome per split, padded
    to 128 windows."""
    kw = {"window_model": "deepsea", "epochs": 2, "results_dir": str(root / "results"),
          "seq_length": 200, **kw}
    cfg = Config(dataroot=str(root / "data"), cell_type="SYN", d_model=D, optim="adam",
                 lr=1e-3, gcn_dropout=0.0, adj_type="constant", joint=True, joint_chunk=CHUNK,
                 **kw)
    if not os.path.exists(cfg.data_path):
        os.makedirs(cfg.dataset_dir)
        tartifact.save_dataset(cfg.data_path, {
            split: tsynthetic.make_window_dataset({chrom: 10}, n_targets=3,
                                                  seq_length=cfg.seq_length, seed=i)
            for i, (split, chrom) in enumerate((("train", "chr2"), ("valid", "chr3"),
                                                ("test", "chr1")))})
    return cfg


def _quiet(*_):
    pass


def _log(run_dir, split):
    return np.array([[float(v) for v in line.split(",")]
                     for line in open(os.path.join(run_dir, f"{split}.log"))])


def test_resume_restores_both_optimizers_and_epoch(tmp_path):
    """A run stopped after epoch 1 and resumed ends where an uninterrupted
    2-epoch run ends: both models, both optimizers' moments, the logs, and
    the checkpoint's epoch."""
    whole = _cfg(tmp_path, name2="whole")
    (w_whole, c_whole), _ = trunner.run(whole, device=CPU, verbose=_quiet)
    cfg = _cfg(tmp_path)
    trunner.run(dataclasses.replace(cfg, epochs=1), device=CPU, verbose=_quiet)
    run_dir = cfg.run_dir + ".joint"
    saved = tckpt.restore_checkpoint(run_dir)
    assert set(saved) == {"window", "chrome", "epoch"} and saved["epoch"] == 1
    assert all(set(saved[k]) == {"model", "optimizer"} for k in ("window", "chrome"))
    msgs = []
    (w_res, c_res), _ = trunner.run(dataclasses.replace(cfg, resume=True), device=CPU,
                                    verbose=msgs.append)
    assert "resumed joint training at epoch 2" in msgs
    for split in ("train", "valid", "test"):
        ours, ref = _log(run_dir, split), _log(whole.run_dir + ".joint", split)
        assert ours.shape == ref.shape == (2, 6), split
        np.testing.assert_allclose(ours, ref, rtol=1e-6, equal_nan=True, err_msg=split)
    assert np.isnan(_log(run_dir, "train")[:, 2:]).all()  # the train line: loss only
    for resumed, ref in ((w_res, w_whole), (c_res, c_whole)):
        for key, value in ref.model.state_dict().items():
            torch.testing.assert_close(resumed.model.state_dict()[key], value, rtol=1e-6,
                                       atol=1e-7)
        ours, want = resumed.optimizer.state_dict()["state"], ref.optimizer.state_dict()["state"]
        assert set(ours) == set(want)
        for i, moments in want.items():
            for kind in ("exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(ours[i][kind], moments[kind], rtol=1e-5, atol=1e-9)


def test_warm_start_from_stage1(tmp_path, capsys):
    """Stage 1's ckpt.pt starts both stages: the whole window model, and the
    chrome model's head from the classifier and head_bn (Expecto). A
    DeepSEA checkpoint stops at the head's warm start with the finetune's
    KeyError; an orbax-only stage-1 directory stops the run."""
    cfg = _cfg(tmp_path, window_model="expecto", epochs=0, seq_length=SEQ)
    wstate = tpt.create_window_state(make_window_model("expecto", 3, SEQ, D), seed=4, device=CPU)
    os.makedirs(cfg.stage1_run_dir)
    tckpt.save_checkpoint(cfg.stage1_run_dir, wstate, epoch=1)
    (tw, tc), _ = trunner.run(cfg, device=CPU)
    assert "joint: warm-started CNN + GCN head from pretrain checkpoint" in capsys.readouterr().out
    for key, value in wstate.model.state_dict().items():
        torch.testing.assert_close(tw.model.state_dict()[key], value, rtol=0, atol=0)
    window = wstate.model.model
    for got, want in ((tc.model.out.weight, window.classifier.weight),
                      (tc.model.batch_norm.running_var, window.head_bn.running_var)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    deepsea = _cfg(tmp_path, epochs=0, results_dir=str(tmp_path / "deepsea"), seq_length=SEQ)
    os.makedirs(deepsea.stage1_run_dir)
    tckpt.save_checkpoint(deepsea.stage1_run_dir, tpt.create_window_state(
        make_window_model("deepsea", 3, SEQ, D), device=CPU), epoch=1)
    with pytest.raises(KeyError, match="only Expecto"):
        trunner.run(deepsea, device=CPU, verbose=_quiet)
    orbax = _cfg(tmp_path, epochs=0, results_dir=str(tmp_path / "orbax"), seq_length=SEQ)
    os.makedirs(os.path.join(orbax.stage1_run_dir, "ckpt"))
    with pytest.raises(NotImplementedError, match="orbax checkpoint"):
        trunner.run(orbax, device=CPU, verbose=_quiet)


@pytest.mark.parametrize("flag,match", [
    ("dp_devices", "does not compose with -dp_devices"),
    ("tp_devices", "does not compose with -dp_devices"),
    ("graph_devices", "needs 2 ranks"),
])
def test_parallel_flags_refused(tmp_path, flag, match):
    """run_joint refuses data and tensor parallelism as the reference does
    (runner.py:565), through the CLI too. -graph_devices 2 runs when the
    process is one of 2 ranks (spawned here over gloo: rank 0 writes the
    logs and both stages' checkpoint), and raises the mesh's error when it
    is not."""
    cfg = _cfg(tmp_path, epochs=1, **{flag: 2})
    error = ValueError if flag == "graph_devices" else NotImplementedError
    with pytest.raises(error, match=match):
        trunner.run_joint(cfg, device=CPU, verbose=_quiet)
    argv = ["-joint", f"-{flag}", "2", "-dataroot", cfg.dataroot, "-results_dir",
            cfg.results_dir, "-cell_type", "SYN", "-d_model", str(D), "-optim", "adam",
            "-lr", "1e-3", "-gcn_dropout", "0", "-adj_type", "constant", "-joint_chunk",
            str(CHUNK), "-window_model", "deepsea", "-seq_length", "200", "-epochs", "1"]
    with pytest.raises(error, match=match):
        tmain.main(argv, device=CPU)
    if flag != "graph_devices":
        return
    ranks = workers.spawn({2: [("cli", dict(argv=argv))]}, tmp_path / "ranks", env=True)
    assert [r["cli"] for r in ranks[2]] == [2, 2]
    run_dir = tmain.config_from_args(tmain.build_parser().parse_args(argv)).run_dir + ".joint"
    assert _log(run_dir, "train").shape == (1, 6) and _log(run_dir, "test").shape == (1, 6)
    assert set(tckpt.restore_checkpoint(run_dir)) == {"window", "chrome", "epoch"}


def test_joint_steps_default_to_the_card(monkeypatch):
    wmodel = tpt.NonStrandSpecific(make_window_model("deepsea", NTARGETS, SEQ, D))
    cmodel = make_chrome_model("gcn", nclass=NTARGETS, nfeat=D)
    tw = tpt.WindowTrainState(wmodel, make_optimizer("adam", LR, wmodel.parameters()))
    tc = tft.ChromeTrainState(cmodel, make_optimizer("adam", LR, cmodel.parameters()))
    tg, _ = _graphs()
    tokens, targets = _world()
    comp = torch.as_tensor(_comp())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tjoint.joint_train_step(tw, tc, tokens, comp, tg, targets, chunk_size=CHUNK)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tjoint.joint_eval_step(tw, tc, tokens, comp, tg, targets, chunk_size=CHUNK)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trunner.run_joint(Config(joint=True))
