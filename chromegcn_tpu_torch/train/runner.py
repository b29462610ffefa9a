"""Epoch loop of the three modes (port of chromegcn_tpu/train/runner.py:
``run``, ``run_pretrain``, ``run_finetune``, ``build_split_graphs``).

- pretrain:   train the window CNN on the dataset file's splits;
- save_feats: one eval-mode pass that dumps every split's per-chromosome
  features (stage 1's checkpoint required);
- finetune:   train the chromosome model (GCN or ChromeRNN) on saved
  features and Hi-C graphs, its head warm-started from stage 1's checkpoint
  where there is one;
- joint:      train the window CNN and the chromosome model together, one
  optimizer step per chromosome (``-joint``, train/joint.py).

Each epoch trains, evaluates the valid and test splits, logs the metrics,
tracks the best epoch and checkpoints (reference: runner.py:62-271,
361-514). The files it reads and writes have the JAX package's names and
formats, apart from the checkpoints (train/checkpoint.py).

More than one device (reference: runner.py:80-118, 321-381, 578-639): the
process must be one of N ranks of ``torch.distributed`` (``torchrun
--nproc_per_node N -m chromegcn_tpu_torch.main ...``; gloo for CPU
tensors, NCCL for CUDA ones), or the mesh raises.
- ``-graph_devices N``: every chromosome graph is cut into N row shards, a
  rank's model sees its own rows, and the halo exchange runs between ranks
  (parallel/graph.py); joint mode runs each rank's rows through the CNN;
- ``-dp_devices N``: each rank trains on its slice of every batch;
- ``-tp_devices M``: the window model's large Linear layers are sliced over
  M ranks (parallel/tp.py); with ``-dp_devices`` too, a dp x tp mesh, the
  model axis minor.
Every rank computes the same metrics from gathered predictions; only rank 0
writes logs, features and checkpoints.

Spans (utils/profiling.py), always recorded: each epoch is an ``epoch``
span over a ``pass`` span a split (its duration, in minutes, is the split's
metrics' ``time``) and the ``metrics``, ``log``, ``snapshot``
(utils/evals.py), ``checkpoint`` and ``save_feats`` spans; each split's
graph build is a ``graph_build`` span.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from chromegcn_tpu_torch import DeviceLike, resolve_device
from chromegcn_tpu_torch.config import Config
from chromegcn_tpu_torch.data import artifact
from chromegcn_tpu_torch.data.loader import (
    ChromFeatures,
    WindowDataset,
    load_chrom_features,
    save_chrom_features,
)
from chromegcn_tpu_torch.models.chrome import make_chrome_model
from chromegcn_tpu_torch.models.window import make_window_model
from chromegcn_tpu_torch.ops import _build
from chromegcn_tpu_torch.ops.seq import complement_permutation
from chromegcn_tpu_torch.ops.sparse import SparseGraph, build_chrom_graph
from chromegcn_tpu_torch.ops.spmm_bsr import BSROperator
from chromegcn_tpu_torch.ops.spmm_hybrid import HybridOperator, attach_auto
from chromegcn_tpu_torch.parallel import tp
from chromegcn_tpu_torch.parallel.graph import shard_graph
from chromegcn_tpu_torch.parallel.mesh import (
    gather_rows, init_distributed, make_mesh, make_mesh_2d, node_sharding,
)
from chromegcn_tpu_torch.train import checkpoint as ckpt
from chromegcn_tpu_torch.train import finetune as ft
from chromegcn_tpu_torch.train import pretrain as pt
from chromegcn_tpu_torch.train.joint import joint_eval_step, joint_train_step
from chromegcn_tpu_torch.train.optim import set_learning_rate, steplr_lr
from chromegcn_tpu_torch.utils import metrics, profiling
from chromegcn_tpu_torch.utils.evals import (
    BestTracker,
    EpochLogger,
    compute_metrics,
    selection_score,
)


class NonFiniteLossError(RuntimeError):
    """Raised when a split's loss goes NaN/Inf (the reference has no such
    check; SURVEY §5)."""


def _check_finite(loss: float, where: str) -> float:
    if not np.isfinite(loss):
        raise NonFiniteLossError(f"non-finite loss ({loss}) during {where}")
    return loss


def _metrics_for(split: str, preds, targs, loss, elapsed, cfg: Config, label_names,
                 device: torch.device):
    """``compute_metrics`` (looked up here at each call) on ``device`` in a
    ``metrics`` span, which records the device type and, as counters, the
    labels scored and the column blocks run; ``elapsed`` is the pass's
    minutes, the metrics' ``time``."""
    with profiling.span("metrics", split=split, device=device.type, counters=metrics.COUNTS):
        return compute_metrics(
            preds, targs, loss, elapsed,
            label_names=label_names, cell_type=cfg.cell_type,
            br_threshold=cfg.br_threshold, device=device,
        )


# optimizer steps that -trace_dir's profiler trace covers
TRACE_STEPS = 10


def _traced(cfg: Config, epoch: int, start_epoch: int):
    """With -trace_dir, a profiler trace (``profiling.trace``) for the train
    pass of the run's second epoch (its first where it has only one), cut at
    TRACE_STEPS optimizer steps; otherwise nothing."""
    if cfg.trace_dir and epoch == min(start_epoch + 1, cfg.epochs):
        return profiling.trace(cfg.trace_dir, steps=TRACE_STEPS)
    return contextlib.nullcontext()


def _quiet(*_):
    pass


def _window_mesh(cfg: Config, verbose):
    """The pretrain's mesh (reference: runner.py:80-118): dp x tp, tp, dp, or
    None on one device."""
    dp, tp_n = cfg.dp_devices, cfg.tp_devices
    if dp > 1 and cfg.batch_size % dp != 0:
        raise ValueError(f"batch_size={cfg.batch_size} must divide dp_devices={dp}")
    if dp > 1 and tp_n > 1:
        verbose(f"2D mesh pretrain: dp={dp} x tp={tp_n}")
        return make_mesh_2d(dp, tp_n, axes=("data", "model"))
    if tp_n > 1:
        verbose(f"tensor-parallel pretrain over {tp_n} devices")
        return make_mesh(tp_n, axis="model")
    if dp > 1:
        verbose(f"data-parallel pretrain over {dp} devices")
        return make_mesh(dp, axis="data")
    return None


def run_pretrain(cfg: Config, splits: Dict[str, WindowDataset],
                 device: DeviceLike = "cuda", verbose=print):
    """Pretrain the window CNN, or dump its features (``-save_feats``);
    returns (state, tracker). Reference: runner.py:62-271, with its data-
    and tensor-parallel meshes (:80-118)."""
    device = resolve_device(device)
    mesh = _window_mesh(cfg, verbose)
    axes = () if mesh is None else mesh.axes
    main = mesh is None or mesh.rank == 0
    verbose = verbose if main else _quiet
    # the data rank offsets the dropout streams; the model ranks of one data
    # row must draw alike, their activations being replicated
    seed = cfg.seed + (mesh.index("data") if "data" in axes else 0)
    train_ds = splits["train"]
    label_names = list(train_ds.tgt_vocab.keys())

    model = make_window_model(
        cfg.window_model, train_ds.n_targets, seq_length=cfg.seq_length, d_model=cfg.d_model
    )
    state = pt.create_window_state(model, cfg.optim, cfg.lr, seed=cfg.seed, device=device)
    # after the state: create_window_state turns TF32 off for the f32 path
    apply_matmul_precision(cfg)
    comp_map = torch.as_tensor(complement_permutation(train_ds.src_vocab), device=device)
    # dropout masks: the model's from this generator; DanQ's LSTM draws its
    # inter-layer dropout from the device's default generator, seeded here
    torch.manual_seed(seed)
    generator = torch.Generator(device=device).manual_seed(seed)
    shuffle_rng = np.random.default_rng(cfg.seed)

    run_dir = cfg.stage1_run_dir
    os.makedirs(run_dir, exist_ok=True)

    if cfg.save_feats or cfg.load_pretrained:
        if not ckpt.checkpoint_exists(run_dir):
            # dumping features from random weights would poison the CNN->GCN
            # handoff; the reference fails here too (reference: main.py:72-77)
            raise FileNotFoundError(
                f"{'save_feats' if cfg.save_feats else 'load_pretrained'} "
                f"requires a trained window checkpoint ({ckpt.CKPT}), but none exists at "
                f"{run_dir!r}: run the pretrain stage first"
            )
        state.model.load_state_dict(ckpt.restore_checkpoint(run_dir, device=device)["model"])
        verbose(f"restored window checkpoint from {run_dir}")

    tracker = BestTracker()
    score_history = []
    start_epoch = 1
    if cfg.resume and cfg.pretrain and ckpt.checkpoint_exists(run_dir):
        restored = ckpt.restore_checkpoint(run_dir, device=device)
        state.model.load_state_dict(restored["model"])
        state.optimizer.load_state_dict(restored["optimizer"])
        start_epoch = int(restored["epoch"]) + 1
        verbose(f"resumed pretraining at epoch {start_epoch}")
    # placed after the restores, which read the single-device layout
    if "model" in axes:
        state = tp.place_window_state(state, mesh)
    if "data" in axes:
        state = pt.data_parallel(state, mesh.group("data"))

    def save(epoch, score):
        # a collective under TP: every rank gathers, rank 0 writes
        payload = tp.full_payload(state) if "model" in axes else state
        if main:
            ckpt.save_checkpoint(run_dir, payload, epoch, cfg.save_mode, score)

    # save_feats shares stage 1's run directory: append, keeping the
    # pretrain epochs' rows (reference: runner.py:162-165)
    logger = EpochLogger(run_dir, append=start_epoch > 1 or cfg.save_feats, writes=main)
    if start_epoch > 1 and logger.best_valid_metric > 0:
        # the pre-resume best seeds the checkpoint-save gate
        score_history.append(logger.best_valid_metric)
    since_improve = 0

    def epoch_pass(split: str, train: bool = False, collect_features: bool = False):
        """One pass over a split: the train pass at -batch_size (training with
        -pretrain, shuffled with -shuffle_train), the others in eval mode at
        -test_batch_size (reference: runner.py:183-236)."""
        is_train = split == "train" and not cfg.save_feats
        return pt.run_window_epoch(
            state, splits[split], comp_map, cfg.batch_size if is_train else cfg.test_batch_size,
            train=train, generator=generator if train else None,
            shuffle=cfg.shuffle_train and is_train, shuffle_rng=shuffle_rng,
            collect_features=collect_features, device=device,
        )

    for epoch in range(start_epoch, cfg.epochs + 1):
        with profiling.span("epoch", epoch=epoch) as ep:
            set_learning_rate(state.optimizer,
                              steplr_lr(cfg.lr, epoch, cfg.lr_decay2 > 0, cfg.lr_step_size2))

            train_metrics = valid_metrics = None
            valid_loss, score = 0.0, 0.0
            valid_out = (None, None)
            if not cfg.test_only and not cfg.save_feats:
                with _traced(cfg, epoch, start_epoch), \
                        profiling.span("pass", split="train", train=cfg.pretrain) as ps:
                    _, preds, targs, loss, _ = epoch_pass("train", cfg.pretrain)
                _check_finite(loss, f"pretrain epoch {epoch}")
                train_metrics = _metrics_for(
                    "train", preds, targs, loss, ps.seconds / 60, cfg, label_names,
                    device,
                )
                with profiling.span("pass", split="valid", train=False) as ps:
                    _, preds, targs, valid_loss, _ = epoch_pass("valid")
                valid_metrics = _metrics_for(
                    "valid", preds, targs, valid_loss, ps.seconds / 60, cfg, label_names,
                    device,
                )
                valid_out = (preds, targs)
                score = selection_score(valid_metrics)
                score_history.append(score)

            with profiling.span("pass", split="test", train=False) as ps:
                _, test_preds, test_targs, test_loss, test_feats = epoch_pass(
                    "test", collect_features=cfg.save_feats
                )
            test_metrics = _metrics_for(
                "test", test_preds, test_targs, test_loss, ps.seconds / 60, cfg, label_names,
                device,
            )

            tracker.evaluate(valid_metrics, test_metrics, epoch)
            if not cfg.save_feats:
                # the feature dump logs no rows: they would follow the pretrain
                # epochs as a duplicate 'epoch 1' (reference: runner.py:214-221)
                with profiling.span("log"):
                    logger.log("train", epoch, train_metrics["loss"] if train_metrics else 0,
                               train_metrics)
                    logger.log("valid", epoch, valid_loss, valid_metrics)
                    logger.log("test", epoch, test_loss, test_metrics)

            if cfg.save_feats:
                # every split's features, in eval mode (reference: runner.py:223-238)
                with profiling.span("save_feats"):
                    for split in ("train", "valid", "test"):
                        feats = (test_feats if split == "test"
                                 else epoch_pass(split, collect_features=True)[4])
                        if main:
                            save_chrom_features(cfg.feature_path(split), feats)
                        verbose(f"saved features: {cfg.feature_path(split)}")
            elif valid_metrics is not None:
                logger.maybe_snapshot(epoch, valid_loss, score, *valid_out, test_preds,
                                      test_targs)
                if cfg.pretrain and (cfg.save_mode == "all" or score >= max(score_history)):
                    with profiling.span("checkpoint"):
                        save(epoch, score)
            with profiling.span("log"):
                verbose(
                    f"epoch {epoch}: test meanAUC={test_metrics['meanAUC']:.4f} "
                    f"meanAUPR={test_metrics['meanAUPR']:.4f} loss={test_loss:.3f} "
                    f"({ep.seconds:.1f} s)"
                )
        if cfg.early_stop_patience > 0 and valid_metrics is not None:
            prior_best = max(score_history[:-1], default=float("-inf"))
            since_improve = 0 if score > prior_best else since_improve + 1
            if since_improve >= cfg.early_stop_patience:
                verbose(
                    f"early stop at epoch {epoch}: no valid-score "
                    f"improvement in {since_improve} epochs"
                )
                break

    return state, tracker


def _use_bsr(cfg: Config, device: torch.device) -> bool:
    """Whether the block-sparse kernel path is in play for this run: asked
    for, or 'auto' on the card."""
    return cfg.spmm_impl == "pallas" or (cfg.spmm_impl == "auto" and device.type == "cuda")


_FORM_NAMES = {BSROperator: "the flat BSR form", HybridOperator: "the hybrid operator"}


def build_split_graphs(
    cfg: Config,
    features: Dict[str, ChromFeatures],
    split: str,
    device: DeviceLike = "cuda",
    edge_capacity: Optional[int] = None,
    verbose=print,
    n_shards: int = 1,
) -> Dict[str, SparseGraph]:
    """Per-chromosome SparseGraphs of one split on ``device``, with the Hi-C
    edges loaded where the adjacency needs them (reference: runner.py:281-318).

    Where the block-sparse path is in play, each graph gets the operator
    form ``-spmm_form`` names (ops/spmm_hybrid.py:attach_auto): the flat BSR
    form, the hybrid one, or for 'auto' whichever the card's cost model
    finds cheaper. ``n_shards`` > 1 pads to lcm(2048, 128 n_shards), so
    each shard's rows are a multiple of the 128-row tile, and attaches no
    flat form: ``shard_split_graphs`` builds the per-shard ones. ChromeRNN
    (``-chrome_model rnn``) reads only the graph's node mask, so its graphs
    get no operator. Spans: a ``graph_build`` over a ``graph`` (the
    adjacency) and an ``operator`` (the host operator build and the cost
    model) for each chromosome."""
    device = resolve_device(device)
    use_bsr = _use_bsr(cfg, device) and n_shards <= 1 and cfg.chrome_model != "rnn"
    bucket = 2048 if n_shards <= 1 else int(np.lcm(2048, 128 * n_shards))
    graphs = {}
    with profiling.span("graph_build", split=split):
        hic_edges = None
        if cfg.adj_type in ("hic", "both"):
            hic_edges = artifact.load_graph_edges(cfg.graph_path(split))
        for chrom, cf in features.items():
            n_valid = cf.forward.shape[0]
            with profiling.span("graph"):
                g = build_chrom_graph(
                    cfg.adj_type,
                    n_valid=n_valid,
                    n_pad=ft.bucket_nodes(n_valid, bucket=bucket),
                    edge_capacity=edge_capacity,
                    hic_edges=None if hic_edges is None else hic_edges[chrom],
                    device=device,
                )
            if use_bsr:
                with profiling.span("operator"):
                    g = attach_auto(g, dtype=cfg.spmm_dtype, strategy=cfg.spmm_form,
                                    device=device)
            graphs[chrom] = g
    if use_bsr:
        forms = sorted({_FORM_NAMES[type(g.bsr)] for g in graphs.values()})
        verbose(
            f"{split}: attached {' and '.join(forms)} ({cfg.spmm_dtype} tiles; "
            f"-spmm_form {cfg.spmm_form}) to {len(graphs)} chromosome graphs"
        )
    return graphs


def _graph_strategy(cfg: Config, device: torch.device) -> str:
    """-graph_strategy, 'auto' resolved as the reference does: halo_bsr where
    the kernel path is in play, else halo."""
    if cfg.graph_strategy != "auto":
        return cfg.graph_strategy
    return "halo_bsr" if _use_bsr(cfg, device) else "halo"


def shard_split_graphs(cfg: Config, graphs, mesh, device: DeviceLike = "cuda",
                       verbose=print):
    """Cut every chromosome graph into the mesh's 'graph' shards and return
    (sharded graphs, placement of each chromosome's rows); reference:
    runner.py:321-358. This rank builds only its own shard's block-sparse
    forms."""
    device = resolve_device(device)
    strategy = _graph_strategy(cfg, device)
    group = mesh.group("graph")
    sharded = {
        split: {chrom: shard_graph(g, mesh.size("graph"), strategy=strategy,
                                   spmm_dtype=cfg.spmm_dtype, group=group)
                for chrom, g in per.items()}
        for split, per in graphs.items()
    }
    verbose(f"node-sharded GCN over {mesh.size('graph')} devices (strategy={strategy})")
    return sharded, node_sharding(mesh)


def apply_matmul_precision(cfg: Config) -> None:
    """The process-wide matmul precision: 'high' and 'highest' keep float32
    matmuls and convolutions f32-faithful (TF32 off, and cuDNN off: its f32
    backward convolutions are not, train/pretrain.py), 'default' allows TF32
    and cuDNN (fast mode, not f32-faithful)."""
    allow = {"high": False, "highest": False, "default": True}[cfg.matmul_precision]
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cudnn.enabled = allow


def run_finetune(cfg: Config, device: DeviceLike = "cuda", verbose=print):
    """Train the chromosome model on saved CNN features. Returns (state, tracker).

    With ``-graph_devices N`` (reference: runner.py:361-381) this process is
    one of N ranks and trains on its rows of every chromosome."""
    device = resolve_device(device)
    mesh = make_mesh(cfg.graph_devices, axis="graph") if cfg.graph_devices > 1 else None
    main = mesh is None or mesh.rank == 0
    verbose = verbose if main else _quiet
    features = {
        split: load_chrom_features(cfg.feature_path(split))
        for split in ("train", "valid", "test")
    }
    n_targets = next(iter(features["train"].values())).target.shape[1]
    label_names = [f"label{i}" for i in range(n_targets)]

    graphs = {
        split: build_split_graphs(cfg, features[split], split, device, verbose=verbose,
                                  n_shards=cfg.graph_devices)
        for split in ("train", "valid", "test")
    }
    place = None
    if mesh is not None:
        graphs, place = shard_split_graphs(cfg, graphs, mesh, device, verbose=verbose)

    model = make_chrome_model(
        cfg.chrome_model, nclass=n_targets, dropout=cfg.gcn_dropout,
        gate=cfg.gate, layers=cfg.gcn_layers, nfeat=cfg.d_model,
        spmm_impl=cfg.spmm_impl, fused=cfg.gcn_fused,
    )
    optim_name, lr = cfg.gcn_optim_and_lr()
    state = ft.create_chrome_state(model, optim_name, lr, seed=cfg.seed, device=device)
    # after the state: create_chrome_state turns TF32 off for the f32 path
    apply_matmul_precision(cfg)

    run_dir = cfg.run_dir
    os.makedirs(run_dir, exist_ok=True)

    start_epoch = 1
    if cfg.resume and ckpt.checkpoint_exists(run_dir):
        restored = ckpt.restore_checkpoint(run_dir, device=device)
        state.model.load_state_dict(restored["model"])
        state.optimizer.load_state_dict(restored["optimizer"])
        start_epoch = int(restored["epoch"]) + 1
        verbose(f"resumed GCN training at epoch {start_epoch}")
    elif cfg.load_gcn and ckpt.checkpoint_exists(run_dir):
        restored = ckpt.restore_checkpoint(run_dir, device=device)
        state.model.load_state_dict(restored["model"])
        verbose("restored GCN checkpoint")
    elif ckpt.checkpoint_exists(cfg.stage1_run_dir):
        # warm-start the head from the CNN checkpoint (reference: runner.py:427-434)
        cnn = ckpt.restore_checkpoint(cfg.stage1_run_dir, device=device)
        ft.warm_start_head_from_window(state.model, cnn["model"])
        verbose("warm-started GCN head from CNN checkpoint")
    elif ckpt.any_checkpoint_exists(cfg.stage1_run_dir):
        # skipping the warm start would train from another start than the
        # reference's
        raise NotImplementedError(
            f"{cfg.stage1_run_dir!r} holds the JAX package's orbax checkpoint "
            f"({ckpt.ORBAX_CKPT}/), which cannot be read without jax: the GCN head's warm "
            f"start needs the port's own {ckpt.CKPT}; run -pretrain through the port"
        )

    tracker = BestTracker()
    logger = EpochLogger(run_dir, append=start_epoch > 1, writes=main)
    score_history = []
    if start_epoch > 1 and logger.best_valid_metric > 0:
        # the pre-resume best seeds the checkpoint-save gate
        score_history.append(logger.best_valid_metric)
    since_improve = 0
    # one seed on every graph rank: a row-sharded dropout draws the whole
    # mask and keeps its rows (models/chrome.py:_dropout)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)

    def epoch_pass(split: str, train: bool):
        return ft.run_chrome_epoch(
            state, features[split], graphs[split], train=train,
            generator=generator if train else None, device=device, place=place,
        )

    for epoch in range(start_epoch, cfg.epochs + 1):
        with profiling.span("epoch", epoch=epoch) as ep:
            lr_e = steplr_lr(lr, epoch, cfg.lr_decay2 > 0, cfg.lr_step_size2)
            set_learning_rate(state.optimizer, lr_e)

            train_metrics = valid_metrics = None
            valid_loss, score = 0.0, 0.0
            valid_out = (None, None)
            if not cfg.load_gcn and not cfg.test_only:
                with _traced(cfg, epoch, start_epoch), \
                        profiling.span("pass", split="train", train=True) as ps:
                    _, preds, targs, loss = epoch_pass("train", True)
                _check_finite(loss, f"finetune epoch {epoch}")
                train_metrics = _metrics_for(
                    "train", preds, targs, loss, ps.seconds / 60, cfg, label_names,
                    device,
                )
                with profiling.span("pass", split="valid", train=False) as ps:
                    _, preds, targs, valid_loss = epoch_pass("valid", False)
                valid_metrics = _metrics_for(
                    "valid", preds, targs, valid_loss, ps.seconds / 60, cfg, label_names,
                    device,
                )
                valid_out = (preds, targs)
                score = selection_score(valid_metrics)
                score_history.append(score)

            with profiling.span("pass", split="test", train=False) as ps:
                _, test_preds, test_targs, test_loss = epoch_pass("test", False)
            test_metrics = _metrics_for(
                "test", test_preds, test_targs, test_loss, ps.seconds / 60, cfg, label_names,
                device,
            )

            tracker.evaluate(valid_metrics, test_metrics, epoch)
            with profiling.span("log"):
                logger.log("train", epoch, train_metrics["loss"] if train_metrics else 0,
                           train_metrics)
                logger.log("valid", epoch, valid_loss, valid_metrics)
                logger.log("test", epoch, test_loss, test_metrics)
            if valid_metrics is not None:
                logger.maybe_snapshot(
                    epoch, valid_loss, score, *valid_out, test_preds, test_targs
                )
                if main and (cfg.save_mode == "all" or score >= max(score_history)):
                    with profiling.span("checkpoint"):
                        ckpt.save_checkpoint(run_dir, state, epoch, cfg.save_mode, score)
            with profiling.span("log"):
                verbose(
                    f"epoch {epoch}: test meanAUC={test_metrics['meanAUC']:.4f} "
                    f"meanAUPR={test_metrics['meanAUPR']:.4f} loss={test_loss:.3f} "
                    f"({ep.seconds:.1f} s)"
                )
        if cfg.early_stop_patience > 0 and valid_metrics is not None:
            prior_best = max(score_history[:-1], default=float("-inf"))
            since_improve = 0 if score > prior_best else since_improve + 1
            if since_improve >= cfg.early_stop_patience:
                verbose(
                    f"early stop at epoch {epoch}: no valid-score "
                    f"improvement in {since_improve} epochs"
                )
                break

    return state, tracker


def run(cfg: Config, splits: Optional[Dict[str, WindowDataset]] = None,
        device: DeviceLike = None, verbose=print):
    """Top-level dispatch (reference: runner.py:536-545); ``splits`` default
    to the dataset file's, ``device`` to the card. With more than one device
    asked for, joins the process group this process was launched into
    (``parallel.mesh.init_distributed``). With ``-trace_dir DIR`` (rank r > 0:
    ``DIR/rank<r>``) every span also times the device, ``DIR/trace.json``
    holds the profiler's trace of a few train steps (``_traced``), and at
    the end ``DIR/spans.json`` holds the spans and the kernel launches and
    the log one line per span name."""
    device = resolve_device(device)
    if max(cfg.graph_devices, cfg.dp_devices, cfg.tp_devices) > 1:
        init_distributed(device)
    if not cfg.trace_dir:
        return _run_mode(cfg, splits, device, verbose)
    rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
    if rank:
        cfg = dataclasses.replace(cfg, trace_dir=os.path.join(cfg.trace_dir, f"rank{rank}"))
    profiling.device_timing(True)
    try:
        return _run_mode(cfg, splits, device, verbose)
    finally:
        profiling.device_timing(False)
        profiling.export(os.path.join(cfg.trace_dir, "spans.json"),
                         {"launches": _build.LAUNCHES})
        if rank == 0:
            for line in profiling.summary():
                verbose(line)


def _run_mode(cfg: Config, splits, device: torch.device, verbose):
    if cfg.joint:
        return run_joint(cfg, splits, device=device, verbose=verbose)
    if cfg.pretrain or cfg.save_feats:
        if splits is None:
            splits = artifact.load_dataset(cfg.data_path)
        return run_pretrain(cfg, splits, device=device, verbose=verbose)
    return run_finetune(cfg, device=device, verbose=verbose)


def _group_tokens_by_chrom(ds: WindowDataset) -> Dict[str, np.ndarray]:
    """Each chromosome's window tokens, in the dataset's chromosome order."""
    return {chrom: ds.tokens[ds.chroms == chrom] for chrom in ds.chrom_order()}


def run_joint(cfg: Config, splits: Optional[Dict[str, WindowDataset]] = None,
              device: DeviceLike = "cuda", verbose=print):
    """Joint CNN+GCN training (reference: runner.py:554-769); returns
    ((wstate, cstate), tracker).

    Each chromosome's windows are padded to a multiple of lcm(2 chunk, 128)
    (not the finetune's 2,048), its graph is built and, where the kernel path
    is in play, given the flat BSR form. Both stages warm-start from stage
    1's checkpoint where there is one. Each epoch trains every chromosome of
    the train split (its log line has the loss only), evaluates valid and
    test, and saves both stages when the valid score improves; there is no
    LR schedule and no early stop, as in the reference.

    With ``-graph_devices N`` (reference: runner.py:578-639) this process is
    one of N ranks: the bucket is lcm(2 chunk, 128 N, chunk N), each graph
    is cut into N shards, and each rank runs its rows' chunks through the
    CNN."""
    if cfg.dp_devices > 1 or cfg.tp_devices > 1:
        # the reference's refusal (runner.py:565)
        raise NotImplementedError(
            "joint CNN+GCN mode does not compose with -dp_devices/-tp_devices; use "
            "-graph_devices for multi-device joint runs, or the staged "
            "pretrain->save_feats->finetune path")
    device = resolve_device(device)
    n_shards = cfg.graph_devices
    mesh = make_mesh(n_shards, axis="graph") if n_shards > 1 else None
    main = mesh is None or mesh.rank == 0
    verbose = verbose if main else _quiet
    if splits is None:
        splits = artifact.load_dataset(cfg.data_path)
    train_ds = splits["train"]
    label_names = list(train_ds.tgt_vocab.keys())
    n_targets = train_ds.n_targets
    comp_map = torch.as_tensor(complement_permutation(train_ds.src_vocab), device=device)
    chunk = cfg.joint_chunk
    bucket = int(np.lcm.reduce([2 * chunk, 128 * n_shards, chunk * n_shards]))
    place = (lambda arr: arr) if mesh is None else node_sharding(mesh)
    if mesh is not None:
        verbose(f"joint: node-sharded over {n_shards} devices")

    data = {}
    for split, ds in splits.items():
        per = {}
        for chrom, tokens in _group_tokens_by_chrom(ds).items():
            n_valid = tokens.shape[0]
            n_pad = ft.bucket_nodes(n_valid, bucket=bucket)
            per[chrom] = {
                "tokens": ft.pad_rows(tokens.astype(np.int32), n_pad),
                "targets": ft.pad_rows(ds.targets[ds.chroms == chrom].astype(np.float32), n_pad),
                "n_valid": n_valid,
            }
        data[split] = per

    hic = {}
    if cfg.adj_type in ("hic", "both"):
        hic = {split: artifact.load_graph_edges(cfg.graph_path(split)) for split in splits}
    use_bsr = _use_bsr(cfg, device)
    graphs = {}
    for split, per in data.items():
        graphs[split] = {}
        with profiling.span("graph_build", split=split):
            for chrom, entry in per.items():
                with profiling.span("graph"):
                    g = build_chrom_graph(
                        cfg.adj_type, n_valid=entry["n_valid"], n_pad=entry["tokens"].shape[0],
                        hic_edges=hic[split][chrom] if hic else None, device=device)
                if mesh is not None:
                    g = shard_graph(g, n_shards, strategy=_graph_strategy(cfg, device),
                                    spmm_dtype=cfg.spmm_dtype, group=mesh.group("graph"))
                elif use_bsr:
                    # no -spmm_dtype here: the reference attaches the operator
                    # without it (runner.py:643), so joint mode runs f32 tiles
                    with profiling.span("operator"):
                        g = attach_auto(g, strategy=cfg.spmm_form, device=device)
                graphs[split][chrom] = g

    wmodel = make_window_model(cfg.window_model, n_targets, seq_length=cfg.seq_length,
                               d_model=cfg.d_model)
    wstate = pt.create_window_state(wmodel, cfg.optim, cfg.lr, seed=cfg.seed, device=device)
    cmodel = make_chrome_model(
        cfg.chrome_model, nclass=n_targets, dropout=cfg.gcn_dropout,
        gate=cfg.gate, layers=cfg.gcn_layers, nfeat=cfg.d_model,
        spmm_impl=cfg.spmm_impl, fused=cfg.gcn_fused,
    )
    optim2, lr2 = cfg.gcn_optim_and_lr()
    cstate = ft.create_chrome_state(cmodel, optim2, lr2, seed=cfg.seed + 1, device=device)
    # after the states: they turn TF32 and cuDNN off for the f32 path
    apply_matmul_precision(cfg)

    run_dir = cfg.run_dir + ".joint"
    start_epoch = 1
    if cfg.resume and ckpt.checkpoint_exists(run_dir):
        restored = ckpt.restore_checkpoint(run_dir, device=device)
        for state, key in ((wstate, "window"), (cstate, "chrome")):
            state.model.load_state_dict(restored[key]["model"])
            state.optimizer.load_state_dict(restored[key]["optimizer"])
        start_epoch = int(restored["epoch"]) + 1
        verbose(f"resumed joint training at epoch {start_epoch}")
    elif ckpt.checkpoint_exists(cfg.stage1_run_dir):
        # both stages from the pretrain checkpoint (reference: runner.py:701-711)
        cnn = ckpt.restore_checkpoint(cfg.stage1_run_dir, device=device)
        wstate.model.load_state_dict(cnn["model"])
        ft.warm_start_head_from_window(cstate.model, cnn["model"])
        verbose("joint: warm-started CNN + GCN head from pretrain checkpoint")
    elif ckpt.any_checkpoint_exists(cfg.stage1_run_dir):
        raise NotImplementedError(
            f"{cfg.stage1_run_dir!r} holds the JAX package's orbax checkpoint "
            f"({ckpt.ORBAX_CKPT}/), which cannot be read without jax: joint mode's warm "
            f"start needs the port's own {ckpt.CKPT}; run -pretrain through the port")

    os.makedirs(run_dir, exist_ok=True)
    tracker = BestTracker()
    logger = EpochLogger(run_dir, append=start_epoch > 1, writes=main)
    # one seed on every graph rank, as run_finetune's
    generator = torch.Generator(device=device).manual_seed(cfg.seed + 2)

    def run_split(split: str, train: bool):
        preds, targs, losses = [], [], []
        for chrom, entry in data[split].items():
            graph = graphs[split][chrom]
            tokens, targets = place(entry["tokens"]), place(entry["targets"])
            if train:
                loss = joint_train_step(wstate, cstate, tokens, comp_map, graph, targets,
                                        generator, chunk, device=device)[2]
            else:
                loss, probs = joint_eval_step(wstate, cstate, tokens, comp_map, graph, targets,
                                              chunk, device=device)
                if mesh is not None:
                    probs = gather_rows(probs, mesh.group("graph"))
                preds.append(probs[:entry["n_valid"]])
                targs.append(entry["targets"][:entry["n_valid"]])
            losses.append(loss)
        total = sum(float(loss) for loss in losses)  # as the reference sums them
        if preds:
            return np.concatenate([p.cpu().numpy() for p in preds]), np.concatenate(targs), total
        return None, None, total

    for epoch in range(start_epoch, cfg.epochs + 1):
        with profiling.span("epoch", epoch=epoch) as ep:
            with _traced(cfg, epoch, start_epoch), \
                    profiling.span("pass", split="train", train=True) as ps_train:
                _, _, train_loss = run_split("train", train=True)
            with profiling.span("pass", split="valid", train=False) as ps:
                v_preds, v_targs, valid_loss = run_split("valid", train=False)
            # the valid metrics' time covers the train and valid passes
            valid_metrics = _metrics_for("valid", v_preds, v_targs, valid_loss,
                                         (ps_train.seconds + ps.seconds) / 60, cfg, label_names,
                                         device)
            with profiling.span("pass", split="test", train=False):
                t_preds, t_targs, test_loss = run_split("test", train=False)
            test_metrics = _metrics_for("test", t_preds, t_targs, test_loss, 0.0, cfg,
                                        label_names, device)
            tracker.evaluate(valid_metrics, test_metrics, epoch)
            with profiling.span("log"):
                # the train step makes no predictions: its line carries the loss only
                logger.log_loss("train", epoch, train_loss)
                logger.log("valid", epoch, valid_loss, valid_metrics)
                logger.log("test", epoch, test_loss, test_metrics)
            score = selection_score(valid_metrics)
            if (logger.maybe_snapshot(epoch, valid_loss, score, v_preds, v_targs, t_preds,
                                      t_targs)
                    and main):
                with profiling.span("checkpoint"):
                    ckpt.save_joint_checkpoint(run_dir, wstate, cstate, epoch)
            with profiling.span("log"):
                verbose(
                    f"epoch {epoch}: joint test meanAUC={test_metrics['meanAUC']:.4f} "
                    f"meanAUPR={test_metrics['meanAUPR']:.4f} loss={test_loss:.3f} "
                    f"({ep.seconds:.1f} s)"
                )
    return (wstate, cstate), tracker
