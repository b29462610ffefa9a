"""The parallel paths through the port's CLI, as N spawned gloo ranks (the
group found through torchrun's environment, tests/torch_parallel_workers.py)
against the JAX package's CLI on the conftest's virtual devices:
``-graph_devices 2`` finetunes with per-epoch losses equal to JAX's, and
``-save_feats`` under ``-dp_devices 2`` writes the features one device
writes (tests/test_train_e2e.py:265). Torch runs on one thread in the
parent and in each rank."""

import dataclasses

import jax
import numpy as np
import pytest

from chromegcn_tpu import main as jmain
from chromegcn_tpu.models.chrome import make_chrome_model as jax_make_chrome_model
from chromegcn_tpu.train import finetune as jft
from chromegcn_tpu.train.optim import make_optimizer as jax_make_optimizer
from chromegcn_tpu_torch import main as tmain
from chromegcn_tpu_torch.data import loader as tloader
from chromegcn_tpu_torch.utils.convert import chromegcn_state_dict
from test_torch_cli import D, NTARGETS, _argv, _log, _window_argv, _write_window_world, _write_world
from test_torch_rnn import torch_one_thread  # noqa: F401 (a fixture)
import torch_parallel_workers as workers


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_graph_devices_cli_matches_jax(tmp_path, impl):
    """2 epochs with -graph_devices 2 through JAX's main (its halo strategy
    over 2 virtual devices) and through the port's as 2 ranks (halo_bsr
    with B1's plain version for -spmm_impl pallas, halo for xla), from JAX's
    initial weights, dropout 0: the per-epoch losses agree to rel 1e-5 and
    the metrics to 1e-4."""
    flags = ["-epochs", "2", "-graph_devices", "2"]
    jcfg = _write_world(tmp_path, results="jax")
    tcfg = _write_world(tmp_path, results="port")
    jmodel = jax_make_chrome_model("gcn", nclass=NTARGETS, dropout=0.0, nfeat=D, spmm_impl="xla")
    _, init_rng = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    jstate = jft.create_chrome_state(jmodel, jax_make_optimizer("sgd", 0.25), init_rng, nfeat=D)
    init = {k: v.numpy() for k, v in chromegcn_state_dict(
        jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)).items()}
    jmain.main(_argv(tmp_path, *flags, "-spmm_impl", "xla", results="jax"))
    argv = _argv(tmp_path, *flags, "-spmm_impl", impl, results="port")
    ranks = workers.spawn({2: [("cli", dict(argv=argv, init=init))]}, tmp_path / "ranks",
                          env=True)
    assert [r["cli"] for r in ranks[2]] == [2, 2]
    for split in ("train", "valid", "test"):
        ours, ref = _log(tcfg, split), _log(jcfg, split)
        assert ours.shape == ref.shape == (2, 6), split
        np.testing.assert_allclose(ours[:, 1], ref[:, 1], rtol=1e-5, err_msg=f"{split} loss")
        np.testing.assert_allclose(ours[:, 2:], ref[:, 2:], rtol=0, atol=1e-4,
                                   err_msg=f"{split} metrics")


def test_save_feats_data_parallel_matches_one_device(tmp_path):
    """-save_feats under -dp_devices 2 (each rank a half of every batch, the
    features gathered, rank 0 writing) dumps what one device dumps, from the
    same stage-1 checkpoint, within the reference test's 5e-5: the CPU's
    GEMMs round a half batch otherwise than a whole one."""
    cfg = _write_window_world(tmp_path)
    tmain.main(_window_argv(tmp_path, "-pretrain", "-epochs", "1"), device="cpu")
    one = _window_argv(tmp_path, "-save_feats")
    tmain.main(one, device="cpu")
    feats = {s: tloader.load_chrom_features(cfg.feature_path(s)) for s in ("train", "valid", "test")}
    workers.spawn({2: [("cli", dict(argv=one + ["-dp_devices", "2"]))]}, tmp_path / "ranks",
                  env=True)
    for split, ref in feats.items():
        got = tloader.load_chrom_features(cfg.feature_path(split))
        assert list(got) == list(ref)
        for chrom, f in ref.items():
            for field in ("forward", "backward", "target"):
                np.testing.assert_allclose(getattr(got[chrom], field), getattr(f, field),
                                           rtol=0, atol=5e-5, err_msg=f"{split} {chrom} {field}")
    assert dataclasses.replace(cfg, dp_devices=2).feature_path("train") == cfg.feature_path("train")
