"""Epoch loop of the three modes (port of chromegcn_tpu/train/runner.py:
``run``, ``run_pretrain``, ``run_finetune``, ``build_split_graphs``).

- pretrain:   train the window CNN on the dataset file's splits;
- save_feats: one eval-mode pass that dumps every split's per-chromosome
  features (stage 1's checkpoint required);
- finetune:   train the chromosome GCN on saved features and Hi-C graphs,
  its head warm-started from stage 1's checkpoint where there is one.

Each epoch trains, evaluates the valid and test splits, logs the metrics,
tracks the best epoch and checkpoints (reference: runner.py:62-271,
361-514). The files it reads and writes have the JAX package's names and
formats, apart from the checkpoints (train/checkpoint.py).

Modes the port lacks raise NotImplementedError naming their ROADMAP item:
``-joint`` (A11), ``-chrome_model rnn`` (A12), more than one device (A13),
``-spmm_form hybrid`` (A9).
"""

from __future__ import annotations

import os
import time
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
from chromegcn_tpu_torch.ops.seq import complement_permutation
from chromegcn_tpu_torch.ops.sparse import SparseGraph, build_chrom_graph
from chromegcn_tpu_torch.ops.spmm_bsr import attach_bsr
from chromegcn_tpu_torch.train import checkpoint as ckpt
from chromegcn_tpu_torch.train import finetune as ft
from chromegcn_tpu_torch.train import pretrain as pt
from chromegcn_tpu_torch.train.optim import set_learning_rate, steplr_lr
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


def _metrics_for(preds, targs, loss, elapsed, cfg: Config, label_names):
    return compute_metrics(
        preds, targs, loss, elapsed,
        label_names=label_names, cell_type=cfg.cell_type,
        br_threshold=cfg.br_threshold,
    )


def check_ported(cfg: Config) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for a mode or
    flag the port does not have yet."""
    missing = []
    if cfg.joint:
        missing.append("-joint (joint CNN+GCN training): ROADMAP A11")
    if cfg.chrome_model == "rnn":
        missing.append("-chrome_model rnn (ChromeRNN): ROADMAP A12")
    if max(cfg.graph_devices, cfg.dp_devices, cfg.tp_devices) > 1:
        missing.append(
            "-graph_devices / -dp_devices / -tp_devices > 1 (the parallel paths): "
            "ROADMAP A13"
        )
    if cfg.spmm_form == "hybrid":
        missing.append("-spmm_form hybrid (the hybrid operator): ROADMAP A9")
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))


def run_pretrain(cfg: Config, splits: Dict[str, WindowDataset],
                 device: DeviceLike = "cuda", verbose=print):
    """Pretrain the window CNN, or dump its features (``-save_feats``);
    returns (state, tracker). Reference: runner.py:62-271, less the
    data- and tensor-parallel meshes (:80-118, ROADMAP A13)."""
    device = resolve_device(device)
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
    torch.manual_seed(cfg.seed)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
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
    # save_feats shares stage 1's run directory: append, keeping the
    # pretrain epochs' rows (reference: runner.py:162-165)
    logger = EpochLogger(run_dir, append=start_epoch > 1 or cfg.save_feats)
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
        t_epoch = time.time()
        set_learning_rate(state.optimizer,
                          steplr_lr(cfg.lr, epoch, cfg.lr_decay2 > 0, cfg.lr_step_size2))

        train_metrics = valid_metrics = None
        valid_loss, score = 0.0, 0.0
        valid_out = (None, None)
        if not cfg.test_only and not cfg.save_feats:
            t0 = time.time()
            _, preds, targs, loss, _ = epoch_pass("train", cfg.pretrain)
            _check_finite(loss, f"pretrain epoch {epoch}")
            train_metrics = _metrics_for(
                preds, targs, loss, (time.time() - t0) / 60, cfg, label_names
            )
            t0 = time.time()
            _, preds, targs, valid_loss, _ = epoch_pass("valid")
            valid_metrics = _metrics_for(
                preds, targs, valid_loss, (time.time() - t0) / 60, cfg, label_names
            )
            valid_out = (preds, targs)
            score = selection_score(valid_metrics)
            score_history.append(score)

        t0 = time.time()
        _, test_preds, test_targs, test_loss, test_feats = epoch_pass(
            "test", collect_features=cfg.save_feats
        )
        test_metrics = _metrics_for(
            test_preds, test_targs, test_loss, (time.time() - t0) / 60, cfg, label_names
        )

        tracker.evaluate(valid_metrics, test_metrics, epoch)
        if not cfg.save_feats:
            # the feature dump logs no rows: they would follow the pretrain
            # epochs as a duplicate 'epoch 1' (reference: runner.py:214-221)
            logger.log("train", epoch, train_metrics["loss"] if train_metrics else 0,
                       train_metrics)
            logger.log("valid", epoch, valid_loss, valid_metrics)
            logger.log("test", epoch, test_loss, test_metrics)

        if cfg.save_feats:
            # every split's features, in eval mode (reference: runner.py:223-238)
            for split in ("train", "valid", "test"):
                feats = test_feats if split == "test" else epoch_pass(split, collect_features=True)[4]
                save_chrom_features(cfg.feature_path(split), feats)
                verbose(f"saved features: {cfg.feature_path(split)}")
        elif valid_metrics is not None:
            logger.maybe_snapshot(epoch, valid_loss, score, *valid_out, test_preds, test_targs)
            if cfg.pretrain and (cfg.save_mode == "all" or score >= max(score_history)):
                ckpt.save_checkpoint(run_dir, state, epoch, cfg.save_mode, score)
        verbose(
            f"epoch {epoch}: test meanAUC={test_metrics['meanAUC']:.4f} "
            f"meanAUPR={test_metrics['meanAUPR']:.4f} loss={test_loss:.3f} "
            f"({time.time() - t_epoch:.1f} s)"
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


def build_split_graphs(
    cfg: Config,
    features: Dict[str, ChromFeatures],
    split: str,
    device: DeviceLike = "cuda",
    edge_capacity: Optional[int] = None,
    verbose=print,
) -> Dict[str, SparseGraph]:
    """Per-chromosome SparseGraphs of one split on ``device``, with the Hi-C
    edges loaded where the adjacency needs them (reference: runner.py:281-318).

    Where the block-sparse path is in play, each graph gets the flat BSR
    form: ``-spmm_form auto`` and ``bsr`` both attach it, since the port has
    no other form yet (the reference's cost model chooses with TPU cost
    constants; ROADMAP A9)."""
    device = resolve_device(device)
    hic_edges = None
    if cfg.adj_type in ("hic", "both"):
        hic_edges = artifact.load_graph_edges(cfg.graph_path(split))
    use_bsr = _use_bsr(cfg, device)
    graphs = {}
    for chrom, cf in features.items():
        n_valid = cf.forward.shape[0]
        g = build_chrom_graph(
            cfg.adj_type,
            n_valid=n_valid,
            n_pad=ft.bucket_nodes(n_valid),
            edge_capacity=edge_capacity,
            hic_edges=None if hic_edges is None else hic_edges[chrom],
            device=device,
        )
        if use_bsr:
            g = attach_bsr(g, dtype=cfg.spmm_dtype, device=device)
        graphs[chrom] = g
    if use_bsr:
        verbose(
            f"{split}: attached the flat BSR form ({cfg.spmm_dtype} tiles; "
            f"-spmm_form {cfg.spmm_form}) to {len(graphs)} chromosome graphs"
        )
    return graphs


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
    """Train the chromosome model on saved CNN features. Returns (state, tracker)."""
    device = resolve_device(device)
    features = {
        split: load_chrom_features(cfg.feature_path(split))
        for split in ("train", "valid", "test")
    }
    n_targets = next(iter(features["train"].values())).target.shape[1]
    label_names = [f"label{i}" for i in range(n_targets)]

    graphs = {
        split: build_split_graphs(cfg, features[split], split, device, verbose=verbose)
        for split in ("train", "valid", "test")
    }

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
    logger = EpochLogger(run_dir, append=start_epoch > 1)
    score_history = []
    if start_epoch > 1 and logger.best_valid_metric > 0:
        # the pre-resume best seeds the checkpoint-save gate
        score_history.append(logger.best_valid_metric)
    since_improve = 0
    generator = torch.Generator(device=device).manual_seed(cfg.seed)

    def epoch_pass(split: str, train: bool):
        return ft.run_chrome_epoch(
            state, features[split], graphs[split], train=train,
            generator=generator if train else None, device=device,
        )

    for epoch in range(start_epoch, cfg.epochs + 1):
        t_epoch = time.time()
        lr_e = steplr_lr(lr, epoch, cfg.lr_decay2 > 0, cfg.lr_step_size2)
        set_learning_rate(state.optimizer, lr_e)

        train_metrics = valid_metrics = None
        valid_loss, score = 0.0, 0.0
        valid_out = (None, None)
        if not cfg.load_gcn and not cfg.test_only:
            t0 = time.time()
            _, preds, targs, loss = epoch_pass("train", True)
            _check_finite(loss, f"finetune epoch {epoch}")
            train_metrics = _metrics_for(
                preds, targs, loss, (time.time() - t0) / 60, cfg, label_names
            )
            t0 = time.time()
            _, preds, targs, valid_loss = epoch_pass("valid", False)
            valid_metrics = _metrics_for(
                preds, targs, valid_loss, (time.time() - t0) / 60, cfg, label_names
            )
            valid_out = (preds, targs)
            score = selection_score(valid_metrics)
            score_history.append(score)

        t0 = time.time()
        _, test_preds, test_targs, test_loss = epoch_pass("test", False)
        test_metrics = _metrics_for(
            test_preds, test_targs, test_loss, (time.time() - t0) / 60, cfg, label_names
        )

        tracker.evaluate(valid_metrics, test_metrics, epoch)
        logger.log("train", epoch, train_metrics["loss"] if train_metrics else 0, train_metrics)
        logger.log("valid", epoch, valid_loss, valid_metrics)
        logger.log("test", epoch, test_loss, test_metrics)
        if valid_metrics is not None:
            logger.maybe_snapshot(
                epoch, valid_loss, score, *valid_out, test_preds, test_targs
            )
            if cfg.save_mode == "all" or score >= max(score_history):
                ckpt.save_checkpoint(run_dir, state, epoch, cfg.save_mode, score)
        verbose(
            f"epoch {epoch}: test meanAUC={test_metrics['meanAUC']:.4f} "
            f"meanAUPR={test_metrics['meanAUPR']:.4f} loss={test_loss:.3f} "
            f"({time.time() - t_epoch:.1f} s)"
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
    to the dataset file's, ``device`` to the card."""
    check_ported(cfg)
    device = resolve_device(device)
    if cfg.pretrain or cfg.save_feats:
        if splits is None:
            splits = artifact.load_dataset(cfg.data_path)
        return run_pretrain(cfg, splits, device=device, verbose=verbose)
    return run_finetune(cfg, device=device, verbose=verbose)
