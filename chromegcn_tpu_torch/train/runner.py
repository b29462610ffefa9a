"""Epoch loop of the finetune mode (port of chromegcn_tpu/train/runner.py:
``run``, ``run_finetune``, ``build_split_graphs``).

Each epoch trains the chromosome GCN on the train split's saved CNN
features and Hi-C graphs, evaluates the valid and test splits, logs the
metrics, tracks the best epoch and checkpoints (reference:
runner.py:361-514). The files it reads and writes have the JAX package's
names and formats, apart from the checkpoint (train/checkpoint.py).

Modes the port lacks raise NotImplementedError naming their ROADMAP item:
``-pretrain`` and ``-save_feats`` (A10), ``-joint`` (A11), ``-chrome_model
rnn`` (A12), more than one device (A13), ``-spmm_form hybrid`` (A9), and
the GCN head's warm start from a CNN checkpoint in the stage-1 run
directory (A10).
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
from chromegcn_tpu_torch.data.loader import ChromFeatures, load_chrom_features
from chromegcn_tpu_torch.models.chrome import make_chrome_model
from chromegcn_tpu_torch.ops.sparse import SparseGraph, build_chrom_graph
from chromegcn_tpu_torch.ops.spmm_bsr import attach_bsr
from chromegcn_tpu_torch.train import checkpoint as ckpt
from chromegcn_tpu_torch.train import finetune as ft
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
    if cfg.pretrain or cfg.save_feats:
        missing.append("-pretrain / -save_feats (the window CNN stage): ROADMAP A10")
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
    matmuls and convolutions f32-faithful (TF32 off), 'default' allows TF32
    (fast mode, not f32-faithful)."""
    allow = {"high": False, "highest": False, "default": True}[cfg.matmul_precision]
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow


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
    elif ckpt.any_checkpoint_exists(cfg.stage1_run_dir):
        # the reference warm-starts the head from the CNN checkpoint here
        # (runner.py:427-434); skipping it would train from another start
        raise NotImplementedError(
            f"a CNN checkpoint is in {cfg.stage1_run_dir!r}: the GCN head's warm "
            "start from it (warm_start_head_from_window) is not ported yet: "
            "ROADMAP A10"
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


def run(cfg: Config, device: DeviceLike = None, verbose=print):
    """Top-level dispatch (reference: runner.py:536-545): the port runs the
    finetune mode; ``device`` defaults to the card."""
    check_ported(cfg)
    return run_finetune(cfg, device=resolve_device(device), verbose=verbose)
