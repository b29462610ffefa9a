"""The ingest chain on the CPU: raw files -> each package's pipeline CLI ->
equal artifacts -> the port's training CLI through its three modes.

Mirrors tests/test_ingest_chain.py (the JAX chain): a make_raw_world of
four chromosomes (chr1 -> test, chr3 -> valid, chr2 and chr4 -> train),
written by the port. ``python -m chromegcn_tpu.pipeline`` and ``python -m
chromegcn_tpu_torch.pipeline`` (their ``main(argv)``) write dataset.npz,
dataset_small.npz (``--small``) and every split's graph file with equal
arrays and vocabularies, also with ``--upsample-5kb`` and the distance
filters. Then the port's training CLI runs -pretrain, -save_feats and
-load_pretrained (Expecto, d_model 16) on the port's artifacts on the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from chromegcn_tpu.pipeline.__main__ import main as jax_pipeline
from chromegcn_tpu_torch.data import artifact
from chromegcn_tpu_torch.data.loader import load_chrom_features
from chromegcn_tpu_torch.data.synthetic_raw import make_raw_world
from chromegcn_tpu_torch.main import build_parser, config_from_args
from chromegcn_tpu_torch.main import main as train_main
from chromegcn_tpu_torch.pipeline.__main__ import main as port_pipeline

SPLIT_CHROMS = {"train": ["chr2", "chr4"], "valid": ["chr3"], "test": ["chr1"]}


@pytest.fixture(scope="module")
def raw_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("ingest")
    raw = str(root / "raw")
    sizes = {"chr1": 40_000, "chr2": 40_000, "chr3": 32_000, "chr4": 32_000}
    stats = make_raw_world(raw, sizes, n_tfbs=2, n_hm=1, n_dnase=1, motif_p=0.25,
                           pairs_per_node=4.0, seed=11, verbose=lambda *a: None)
    return root, raw, stats


def _argv(raw, out, *extra):
    return ["--fasta", os.path.join(raw, "genome.fa"), "--peaks", os.path.join(raw, "peaks"),
            "--hic", os.path.join(raw, "hic"), "--out", out, *extra]


def _npz(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


FLAGS = {
    "default": ["--hicsize", "2000", "--hicnorm", "SQRTVC", "--small", "8"],
    "upsample-5kb": ["--hicsize", "600", "--hicnorm", "", "--upsample-5kb"],
    "distance filters": ["--hicsize", "800", "--hicnorm", "SQRTVC", "--min-dist", "2000",
                         "--max-dist", "20000"],
    "short sequences": ["--hicsize", "1000", "--hicnorm", "VC", "--extended", "400",
                        "--min-frac", "0.24", "--resolution", "1000"],
}


@pytest.mark.parametrize("name", FLAGS)
def test_pipeline_clis_write_equal_files(raw_world, name, capsys):
    root, raw, stats = raw_world
    flags = FLAGS[name]
    outs = {pkg: str(root / name / pkg / "SYNRAW" / "1000") for pkg in ("jax", "port")}
    jax_pipeline(_argv(raw, outs["jax"], *flags))
    port_pipeline(_argv(raw, outs["port"], *flags))
    printed = capsys.readouterr().out.splitlines()
    half = len(printed) // 2
    assert [l.replace(outs["jax"], outs["port"]) for l in printed[:half]] == printed[half:]
    names = ["dataset.npz"] + (["dataset_small.npz"] if "--small" in flags else [])
    hicsize, hicnorm = flags[1], flags[3]
    names += [os.path.join("hic", f"{s}_graphs_{hicsize}_{hicnorm}norm.npz")
              for s in SPLIT_CHROMS]
    for pkg in ("jax", "port"):
        assert sorted(os.listdir(outs[pkg])) == sorted(["hic"] + names[:-3])
    for rel in names:
        ours, ref = _npz(os.path.join(outs["port"], rel)), _npz(os.path.join(outs["jax"], rel))
        assert sorted(ours) == sorted(ref), rel
        for key, want in ref.items():
            assert ours[key].dtype == want.dtype, (rel, key)
            np.testing.assert_array_equal(ours[key], want, err_msg=f"{rel} {key}")
    meta = json.loads(bytes(_npz(os.path.join(outs["port"], "dataset.npz"))["meta"]).decode())
    assert sorted(meta["tgt_vocab"]) == sorted(stats["assays"])

    # the port's files hold the ground truth
    splits = artifact.load_dataset(os.path.join(outs["port"], "dataset.npz"))
    for split, chroms in SPLIT_CHROMS.items():
        assert sorted(set(splits[split].chroms)) == chroms
        assert len(splits[split].starts) == sum(stats["chroms"][c]["kept_windows"] for c in chroms)
    assert sum(int(s.targets.sum()) for s in splits.values()) == sum(
        c["positives"] for c in stats["chroms"].values())
    if "--small" in flags:
        small = artifact.load_dataset(os.path.join(outs["port"], "dataset_small.npz"))
        assert all(len(ds.starts) == 8 for ds in small.values())
    edges = artifact.load_graph_edges(os.path.join(outs["port"], names[-1]))
    s, r, _ = edges["chr1"]
    assert len(s) > 0 and max(s.max(), r.max()) < stats["chroms"]["chr1"]["kept_windows"]
    pairs = set(zip(s.tolist(), r.tolist()))
    assert all((b, a) in pairs for a, b in pairs)


@pytest.fixture
def one_thread():
    """torch's CPU ops on one thread: the test workers share the cores, and
    Expecto's convolutions slow down when every worker runs a full pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_training_cli_runs_on_the_ports_artifacts(raw_world, one_thread):
    """The commands a user runs after the port's pipeline, on the CPU:
    -pretrain, -save_feats, then -load_pretrained over the Hi-C graphs.
    The pipeline cuts 400-base sequences (``--extended 400``) around each
    1 kb window, so Expecto runs at seq 400 (a fifth of the default's
    convolutions; the equality of the files at 2,000 is shown above)."""
    root, raw, stats = raw_world
    port_pipeline(_argv(raw, str(root / "chain" / "SYNRAW" / "1000"),
                        "--hicsize", "125000", "--hicnorm", "SQRTVC", "--extended", "400"))
    common = ["-dataroot", str(root / "chain"), "-results_dir", str(root / "results"),
              "-cell_type", "SYNRAW", "-batch_size", "8", "-seq_length", "400",
              "-d_model", "16", "-optim", "adam", "-lr", "0.001", "-adj_type", "hic",
              "-hicsize", "125000", "-hicnorm", "SQRTVC"]

    def cfg(*extra):
        return config_from_args(build_parser().parse_args(common + list(extra)))

    def log(run_dir, split):
        with open(os.path.join(run_dir, f"{split}.log")) as f:
            return [[float(v) for v in line.split(",")] for line in f]

    train_main(common + ["-pretrain", "-epochs", "1"], device="cpu")
    assert all(np.isfinite(log(cfg("-pretrain").stage1_run_dir, "train")[0][1:2]))
    train_main(common + ["-save_feats"], device="cpu")
    for split, chroms in SPLIT_CHROMS.items():
        feats = load_chrom_features(cfg().feature_path(split))
        assert sorted(feats) == chroms
        for chrom, cf in feats.items():
            n = stats["chroms"][chrom]["kept_windows"]
            assert cf.forward.shape == cf.backward.shape == (n, 16)
            assert cf.target.shape == (n, stats["n_assays"])
            assert np.isfinite(cf.forward).all() and np.isfinite(cf.backward).all()
    ft = ["-load_pretrained", "-epochs", "1"]
    train_main(common + ft, device="cpu")
    run_dir = cfg(*ft).run_dir
    assert ".adj_hic.norm_SQRTVC" in run_dir
    for split in ("train", "valid", "test"):
        rows = log(run_dir, split)
        assert len(rows) == 1 and np.isfinite(rows[0][1])
    assert all(np.isfinite(log(run_dir, "test")[0]))
