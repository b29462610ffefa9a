"""The port's spans, counters and traces (utils/profiling.py), and where the
train steps, the runner and the CLI's ``-trace_dir`` record them, on the
CPU."""

import collections
import contextlib
import json
import os
import time
import types

import numpy as np
import pytest
import torch

from chromegcn_tpu_torch import main as tmain
from chromegcn_tpu_torch.config import Config
from chromegcn_tpu_torch.data import artifact
from chromegcn_tpu_torch.data.constants import SRC_VOCAB
from chromegcn_tpu_torch.data.loader import (ChromFeatures, load_chrom_features,
                                             save_chrom_features)
from chromegcn_tpu_torch.data.synthetic import make_hic_edges, make_window_dataset
from chromegcn_tpu_torch.models.chrome import make_chrome_model
from chromegcn_tpu_torch.models.window import make_window_model
from chromegcn_tpu_torch.ops import _build
from chromegcn_tpu_torch.ops.seq import complement_permutation
from chromegcn_tpu_torch.ops.sparse import build_chrom_graph
from chromegcn_tpu_torch.train import finetune as ft
from chromegcn_tpu_torch.train import pretrain as pt
from chromegcn_tpu_torch.train import runner
from chromegcn_tpu_torch.utils import profiling

CPU = "cpu"
D, NTARGETS = 16, 5
SIZES = {"train": {"chr2": 300, "chr4": 200}, "valid": {"chr3": 250}, "test": {"chr1": 260}}


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """An empty ring and per-name totals for each test, torch on one thread
    (the suite runs six workers), device timing off after."""
    monkeypatch.setattr(profiling, "_ring", collections.deque(maxlen=profiling.RING))
    monkeypatch.setattr(profiling, "_totals", {})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    profiling.device_timing(False)


def _quiet(*_):
    pass


def _children(done):
    out = collections.defaultdict(list)
    for s in done:
        out[s.parent].append(s)
    return out


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------


def test_spans_nest_with_their_parent_ids():
    with profiling.span("a", k=1) as a:
        with profiling.span("b") as b:
            with profiling.span("c") as c:
                pass
        with profiling.span("d") as d:
            pass
    done = profiling.spans()
    assert [s.name for s in done] == ["c", "b", "d", "a"]
    assert (a.parent, b.parent, c.parent, d.parent) == (0, a.id, b.id, a.id)
    assert a.attrs == {"k": 1} and b.attrs == {}
    assert (a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns
            <= d.end_ns <= a.end_ns)
    assert not any(s.error for s in done) and all(s.device_ms is None for s in done)
    assert a.seconds >= b.seconds + d.seconds > 0


def test_an_exception_is_recorded_and_raised_again():
    class Boom(Exception):
        pass

    with pytest.raises(Boom):
        with profiling.span("outer"):
            with profiling.span("inner"):
                raise Boom
    inner, outer = profiling.spans()
    assert inner.error and outer.error and inner.parent == outer.id
    with profiling.span("after") as after:
        pass
    assert after.parent == 0 and not after.error


def test_the_ring_is_bounded_and_the_totals_outlive_it():
    with profiling.span("setup"):
        pass
    for _ in range(profiling.RING + 10):
        with profiling.span("tick"):
            pass
    done = profiling.spans()
    assert len(done) == profiling.RING and all(s.name == "tick" for s in done)
    totals = profiling.totals()
    assert totals["tick"]["count"] == profiling.RING + 10
    assert totals["setup"]["count"] == 1 and totals["setup"]["host_s"] > 0
    assert totals["setup"]["device_ms"] is None


def test_counters_become_the_span_attributes():
    launches = collections.Counter(bsr_spmm=5)
    with profiling.span("train_step", counters=launches, split="x") as s:
        launches["bsr_spmm"] += 8
        launches["gcn_fused_fwd"] += 2
    assert s.attrs == {"split": "x", "bsr_spmm": 8, "gcn_fused_fwd": 2}


def test_record_function_is_entered_only_while_a_profiler_runs(monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    with profiling.span("quiet"):
        pass
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("loud"):
            pass
    assert entered == ["loud"]


def test_cuda_events_are_made_only_with_device_timing(monkeypatch):
    """With device timing off no event is made; on, each span records two,
    pooled, and reads their elapsed time (a stand-in for torch.cuda.Event
    on the CPU)."""
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            made.append(self)

        def record(self):
            self.at = time.perf_counter()

        def query(self):
            return True

        def elapsed_time(self, end):
            return (end.at - self.at) * 1e3

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    with profiling.span("off"):
        pass
    assert made == [] and profiling.spans()[-1].device_ms is None
    profiling.device_timing(True)
    for _ in range(3):
        with profiling.span("on"):
            time.sleep(1e-3)
    profiling.device_timing(False)
    with profiling.span("off"):
        pass
    profiling.resolve()
    assert len(made) == 2  # resolved as each span ended, and reused
    on = [s for s in profiling.spans() if s.name == "on"]
    assert all(s.device_ms >= 1.0 for s in on)
    assert profiling.totals()["on"]["device_ms"] == pytest.approx(sum(s.device_ms for s in on))
    assert profiling.totals()["off"]["device_ms"] is None


def test_an_exported_span_lies_on_the_profiler_clock(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("warm"):  # record_function's first entry sets it up
            pass
        with profiling.span("probe"):
            torch.ones(8).sum()
    profiling.export(str(tmp_path / "spans.json"), {"launches": {"bsr_spmm": 3}})
    with open(tmp_path / "trace.json") as f:
        prof = json.load(f)
    with open(tmp_path / "spans.json") as f:
        ours = json.load(f)
    theirs = next(e for e in prof["traceEvents"] if e.get("name") == "probe")
    mine = next(e for e in ours["traceEvents"] if e.get("name") == "probe")
    assert theirs["cat"] == "user_annotation" and mine["ph"] == "X"
    gap_us = ((mine["ts"] + ours["baseTimeNanoseconds"] / 1e3)
              - (theirs["ts"] + prof["baseTimeNanoseconds"] / 1e3))
    assert abs(gap_us) < 100, gap_us
    counter = next(e for e in ours["traceEvents"] if e["ph"] == "C")
    assert counter["name"] == "launches" and counter["args"] == {"bsr_spmm": 3}
    assert ours["spanTotals"]["probe"]["count"] == 1


def test_a_kernel_load_is_a_span(monkeypatch):
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "build", lambda name: None)
    monkeypatch.setattr(_build, "library_path", lambda name: name)
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: types.SimpleNamespace(
                            kernel_error_string=types.SimpleNamespace()))
    _build.load("bsr_spmm")
    _build.load("bsr_spmm")  # cached: no second span
    (s,) = profiling.spans()
    assert s.name == "kernel_load" and s.attrs == {"name": "bsr_spmm"}


# ---------------------------------------------------------------------------
# the train steps and the runner
# ---------------------------------------------------------------------------


def _gcn_step():
    model = make_chrome_model("gcn", nclass=NTARGETS, dropout=0.0, nfeat=D)
    state = ft.create_chrome_state(model, "sgd", 0.1, device=CPU)
    edges = make_hic_edges(100, 300, seed=1)
    graph = build_chrom_graph("hic", n_valid=100, n_pad=128, hic_edges=edges, device=CPU)
    gen = torch.Generator().manual_seed(0)
    x_f, x_r = torch.randn(128, D, generator=gen), torch.randn(128, D, generator=gen)
    targets = (torch.rand(128, NTARGETS, generator=gen) < 0.2).float()
    ft.chrome_train_step(state, x_f, x_r, graph, targets, device=CPU)
    ft.chrome_eval_step(state, x_f, x_r, graph, targets, device=CPU)


def _window_step():
    ds = make_window_dataset({"chr1": 8}, n_targets=3, seq_length=200, seed=0)
    model = make_window_model("deepsea", 3, seq_length=200, d_model=8)
    state = pt.create_window_state(model, "sgd", 0.1, device=CPU)
    comp = torch.as_tensor(complement_permutation(SRC_VOCAB))
    mask = np.ones(8, bool)
    pt.window_train_step(state, ds.tokens, ds.targets.astype(np.float32), mask, comp,
                         device=CPU)
    pt.window_eval_step(state, ds.tokens, ds.targets.astype(np.float32), mask, comp,
                        device=CPU)


@pytest.mark.parametrize("step", [_gcn_step, _window_step], ids=["gcn", "window"])
def test_a_train_step_records_its_phases(step):
    step()
    done = profiling.spans()
    kids = _children(done)
    (train,) = [s for s in done if s.name == "train_step"]
    assert train.parent == 0 and not train.error
    assert [s.name for s in kids[train.id]] == [
        "optimizer", "forward", "backward", "optimizer", "loss"]
    forward = kids[train.id][1]
    assert [s.name for s in kids[forward.id]] == ["loss"]
    assert [s.name for s in done if s.parent == 0] == ["train_step", "eval_step"]


def _rnn_step():
    """One ChromeRNN train step (2 bidirectional layers) over a chromosome
    of 200 windows padded to 256."""
    model = make_chrome_model("rnn", nclass=NTARGETS, dropout=0.2, layers=2, nfeat=D)
    state = ft.create_chrome_state(model, "sgd", 0.1, device=CPU)
    graph = build_chrom_graph("none", n_valid=200, n_pad=256, device=CPU)
    gen = torch.Generator().manual_seed(0)
    x_f, x_r = torch.randn(256, D, generator=gen), torch.randn(256, D, generator=gen)
    targets = (torch.rand(256, NTARGETS, generator=gen) < 0.2).float()
    ft.chrome_train_step(state, x_f, x_r, graph, targets, gen, device=CPU)


def test_a_chromernn_step_records_its_lstm_sweeps():
    """Each ``lstm_forward`` call is an ``lstm`` span under ``forward``, and
    ``train_step`` carries the sweeps and positions: 2 strands x 2 layers,
    each over the 256 padded rows."""
    _rnn_step()
    done = profiling.spans()
    kids = _children(done)
    (train,) = [s for s in done if s.name == "train_step"]
    forward = next(s for s in kids[train.id] if s.name == "forward")
    assert [s.name for s in kids[forward.id]] == ["lstm"] * 4 + ["loss"]
    assert all(s.attrs == {"positions": 256, "batch": 1, "directions": 2}
               for s in kids[forward.id][:4])
    assert train.attrs["lstm_sweeps"] == 4 and train.attrs["lstm_positions"] == 4 * 256


def test_a_chromegcn_step_records_no_lstm():
    _gcn_step()
    done = profiling.spans()
    assert not [s for s in done if s.name == "lstm"]
    (train,) = [s for s in done if s.name == "train_step"]
    assert train.attrs.get("lstm_sweeps", 0) == 0 and train.attrs.get("lstm_positions", 0) == 0


def _finetune_world(root, **more) -> Config:
    """Saved CNN features and Hi-C edges of ``SIZES``, where the finetune
    mode reads them."""
    cfg = Config(dataroot=str(root / "data"), results_dir=str(root / "results"),
                 cell_type="SYN", load_pretrained=True, d_model=D, optim="sgd", lr=0.25,
                 adj_type="hic", gcn_dropout=0.0, **more)
    os.makedirs(cfg.stage1_run_dir, exist_ok=True)
    os.makedirs(cfg.graph_root, exist_ok=True)
    rng = np.random.default_rng(0)
    for i, (split, chroms) in enumerate(SIZES.items()):
        feats, edges = {}, {}
        for j, (chrom, n) in enumerate(chroms.items()):
            feats[chrom] = ChromFeatures(
                forward=rng.normal(size=(n, D)).astype(np.float32),
                backward=rng.normal(size=(n, D)).astype(np.float32),
                target=(rng.random((n, NTARGETS)) < 0.2).astype(np.float32))
            edges[chrom] = make_hic_edges(n, 4 * n, seed=10 * i + j)
        save_chrom_features(cfg.feature_path(split), feats)
        artifact.save_graph_edges(cfg.graph_path(split), edges)
    return cfg


def _window_world(root, **more) -> Config:
    cfg = Config(dataroot=str(root / "data"), results_dir=str(root / "results"),
                 cell_type="SYN", seq_length=200, batch_size=8, d_model=8,
                 window_model="deepsea", optim="sgd", lr=0.1, adj_type="constant",
                 joint_chunk=8, **more)
    os.makedirs(cfg.dataset_dir, exist_ok=True)
    artifact.save_dataset(cfg.data_path, {
        split: make_window_dataset({chrom: 12}, n_targets=3, seq_length=200, seed=i)
        for i, (split, chrom) in enumerate((("train", "chr2"), ("valid", "chr3"),
                                            ("test", "chr1")))})
    return cfg


@pytest.mark.parametrize("model", ["gcn", "rnn"])
def test_chromernn_graphs_carry_no_operator(tmp_path, model):
    """ChromeRNN reads only the node mask, so its graphs get no operator;
    the GCN's get the form ``-spmm_form`` names, as before."""
    cfg = _finetune_world(tmp_path, spmm_impl="pallas", chrome_model=model)
    feats = load_chrom_features(cfg.feature_path("train"))
    lines = []
    graphs = runner.build_split_graphs(cfg, feats, "train", CPU, verbose=lines.append)
    assert sorted(graphs) == sorted(SIZES["train"])
    for chrom, g in graphs.items():
        assert g.n_nodes == ft.bucket_nodes(SIZES["train"][chrom])
        if model == "rnn":
            assert g.bsr is None
        else:
            want = runner.attach_auto(g.replace(bsr=None), device=CPU).bsr
            assert g.bsr is not None and type(g.bsr) is type(want)
    assert bool(lines) == (model == "gcn")


@contextlib.contextmanager
def _metric_times(monkeypatch):
    """The ``time`` of every metrics dict the runner makes, in order."""
    times = []
    real = runner.compute_metrics

    def compute(*a, **kw):
        out = real(*a, **kw)
        times.append(out["time"])
        return out

    monkeypatch.setattr(runner, "compute_metrics", compute)
    yield times


def test_run_finetune_records_every_epoch_and_its_passes(tmp_path, monkeypatch):
    cfg = _finetune_world(tmp_path, epochs=2, spmm_impl="pallas")
    with _metric_times(monkeypatch) as times:
        runner.run_finetune(cfg, device=CPU, verbose=_quiet)
    done = profiling.spans()
    kids = _children(done)
    epochs = [s for s in done if s.name == "epoch"]
    assert [e.attrs for e in epochs] == [{"epoch": 1}, {"epoch": 2}]
    passes = []
    for e in epochs:
        names = [s.name for s in kids[e.id]]
        assert names.count("pass") == 3 and names.count("metrics") == 3
        assert names.count("log") == 2
        assert set(names) <= {"pass", "metrics", "log", "snapshot", "checkpoint"}
        ps = [s for s in kids[e.id] if s.name == "pass"]
        assert [p.attrs["split"] for p in ps] == ["train", "valid", "test"]
        assert [m.attrs["split"] for m in kids[e.id] if m.name == "metrics"] == [
            "train", "valid", "test"]
        passes += ps
        # the runner hands compute_metrics its device; the span counts the
        # world's labels and the column blocks that scored them
        for m in kids[e.id]:
            if m.name == "metrics":
                assert m.attrs["device"] == CPU and m.attrs["labels"] == NTARGETS
                assert m.attrs["blocks"] >= 1
        train_steps = [s for s in kids[ps[0].id] if s.name == "train_step"]
        assert len(train_steps) == len(SIZES["train"])
    # the valid loss and score improve from nothing in epoch 1: two snapshots
    assert [s.name for s in kids[epochs[0].id]].count("snapshot") == 2
    assert all(kids[s.parent] for s in done if s.name == "snapshot")
    # each pass's metrics time is its span's duration, in minutes
    assert times == [p.seconds / 60 for p in passes]
    builds = [s for s in done if s.name == "graph_build"]
    assert [b.attrs["split"] for b in builds] == ["train", "valid", "test"]
    assert [s.name for s in kids[builds[0].id]] == ["graph", "operator"] * 2
    assert profiling.totals()["graph_build"]["count"] == 3


@pytest.mark.parametrize("mode", ["pretrain", "joint"])
def test_run_pretrain_and_joint_record_their_epochs(tmp_path, monkeypatch, mode):
    cfg = _window_world(tmp_path, epochs=2, **{mode: True})
    with _metric_times(monkeypatch) as times:
        runner.run(cfg, device=CPU, verbose=_quiet)
    done = profiling.spans()
    kids = _children(done)
    epochs = [s for s in done if s.name == "epoch"]
    assert [e.attrs["epoch"] for e in epochs] == [1, 2]
    for e, t in zip(epochs, np.reshape(times, (2, -1))):
        ps = [s for s in kids[e.id] if s.name == "pass"]
        assert [p.attrs["split"] for p in ps] == ["train", "valid", "test"]
        assert [p.attrs["train"] for p in ps] == [True, False, False]
        if mode == "pretrain":
            assert list(t) == [p.seconds / 60 for p in ps]
        else:  # the valid time covers the train and valid passes; test's is 0
            assert list(t) == [(ps[0].seconds + ps[1].seconds) / 60, 0.0]
    assert any(s.name == "checkpoint" for s in done)
    if mode == "joint":
        assert sorted(s.attrs["split"] for s in done if s.name == "graph_build") == [
            "test", "train", "valid"]


def test_trace_dir_writes_the_spans_and_a_cut_trace(tmp_path, monkeypatch, capsys):
    _finetune_world(tmp_path)
    out = tmp_path / "trace"
    monkeypatch.setattr(runner, "TRACE_STEPS", 1)
    tmain.main(["-dataroot", str(tmp_path / "data"), "-results_dir", str(tmp_path / "results"),
                "-cell_type", "SYN", "-load_pretrained", "-d_model", str(D), "-optim", "sgd",
                "-lr", "0.25", "-gcn_dropout", "0", "-epochs", "3", "-trace_dir", str(out)],
               device=CPU)
    with open(out / "spans.json") as f:
        spans = json.load(f)
    events = spans["traceEvents"]
    assert all({"ph", "name", "pid", "tid"} <= set(e) for e in events)
    epochs = [e for e in events if e["name"] == "epoch" and e["ph"] == "X"]
    assert [e["args"]["epoch"] for e in epochs] == [1, 2, 3]
    assert all(e["dur"] > 0 and not e["args"]["error"] for e in epochs)
    assert spans["spanTotals"]["epoch"]["count"] == 3
    scored = [e["args"] for e in events if e["name"] == "metrics" and e["ph"] == "X"]
    assert len(scored) == 9
    assert all(a["device"] == CPU and a["labels"] == NTARGETS and a["blocks"] >= 1
               for a in scored)
    with open(out / "trace.json") as f:
        trace = json.load(f)
    steps = [e for e in trace["traceEvents"]
             if e.get("name") == "train_step" and e.get("cat") == "user_annotation"]
    # the second epoch's train pass, cut after TRACE_STEPS optimizer steps
    assert len(steps) == 1
    printed = capsys.readouterr().out
    assert "span epoch: 3 x" in printed and "span train_step: 6 x" in printed
