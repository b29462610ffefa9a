"""Typed configuration with reference-compatible flags and experiment IDs
(port of chromegcn_tpu/config.py: the same fields, defaults and derived
paths, so a run of either package finds the other's files; ``trace_dir``
is the port's own and names no file of the run).

Replaces the reference's argparse namespace + results-dir string encoding
(reference: config_args.py:4-143) with a dataclass, while still emitting a
compatible experiment-ID string (the de-facto run key that the reference's
analysis scripts parse — reference: scripts/analyze_results.py:57-60).

Reference quirks handled deliberately (SURVEY §5 "document-and-diverge"):
- ``optim2/lr2/lr_decay2/lr_step_size2`` are *named* in the run dir but the
  reference optimizer factory only reads ``optim``/``lr``
  (reference: utils/util_methods.py:14-19). We keep the fields and the
  naming, and route the stage-2 values to the GCN stage properly (divergence:
  configurable via ``use_stage2_hparams``; default False = reference
  behavior).
- ``save_feats`` forces pretrain=False, no shuffle, 1 epoch
  (reference: config_args.py:89-92).
- The GCN stage forces batch_size 512 in the reference
  (reference: config_args.py:137-139) — vestigial (the GCN batch is a
  chromosome); we drop it and note it here.
- Interactive overwrite prompt (config_args.py:129-135) is replaced by an
  explicit ``overwrite`` flag (no prompts in production runs).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass
class Config:
    # paths
    dataroot: str = "processed_data"
    results_dir: str = "results"
    cell_type: str = "GM12878"
    window_size: str = "1000"

    # schedule
    epochs: int = 100
    batch_size: int = 64
    test_batch_size: int = -1

    # model
    d_model: int = 128
    window_model: str = "expecto"
    chrome_model: str = "gcn"
    seq_length: int = 2000
    gcn_layers: int = 2
    gate: bool = True
    dropout: float = 0.1
    gcn_dropout: float = 0.2

    # optimizer (stage 1 = CNN)
    optim: str = "adam"
    lr: float = 0.0002
    lr_decay: float = 0.0
    lr_step_size: int = 1
    weight_decay: float = 5e-5
    # stage 2 (GCN) — reference parses these but never routes them (see module doc)
    optim2: str = "adam"
    lr2: float = 0.002
    lr_decay2: float = 0.0
    lr_step_size2: int = 100
    use_stage2_hparams: bool = False

    # graph
    adj_type: str = "hic"          # constant | hic | both | none
    hicnorm: str = "SQRTVC"        # KR | VC | SQRTVC | ''
    hicsize: str = "500000"        # 125000 | 250000 | 500000 | 1000000
    spmm_impl: str = "auto"
    spmm_dtype: str = "float32"  # float32 (parity) | bfloat16 (fast)
    # block-sparse operator form: 'auto' | 'bsr' | 'hybrid'; 'auto' picks by
    # the card's cost model (ops/spmm_hybrid.py:attach_auto)
    spmm_form: str = "auto"
    # fused gated-GCN-layer kernels (ops/gcn_fused.py, B2/B3): 'off' | 'on'
    gcn_fused: str = "off"
    # f32-faithful GEMMs by default: 'high' and 'highest' keep TF32 off on
    # the card, 'default' turns it on (fast mode, not f32-faithful)
    matmul_precision: str = "high"  # high (parity) | highest | default (fast)

    # modes
    pretrain: bool = False
    save_feats: bool = False
    load_pretrained: bool = False
    load_gcn: bool = False
    test_only: bool = False
    joint: bool = False      # end-to-end CNN+GCN finetune (train/joint.py)
    joint_chunk: int = 128   # CNN remat chunk size in joint mode
    resume: bool = False     # resume epochs from the latest checkpoint

    # misc
    loss: str = "ce"
    br_threshold: float = 0.5
    save_mode: str = "best"
    # stop after this many epochs without a valid selection-score
    # improvement (0 = off, reference behavior: fixed epoch count,
    # reference README.md:34 trains a fixed 100 epochs)
    early_stop_patience: int = 0
    shuffle_train: bool = False
    small: bool = False
    overwrite: bool = False
    seed: int = 0
    name: Optional[str] = None
    name2: Optional[str] = None

    # parallelism: > 1 runs as that many torch.distributed ranks (train/runner.py)
    dp_devices: int = 1            # data-parallel mesh size for CNN stage
    graph_devices: int = 1         # node-partition mesh size for GCN stage
    tp_devices: int = 1            # tensor-parallel shards for the CNN feature kernel
    graph_strategy: str = "auto"   # auto | halo_bsr | halo | all_gather (parallel/graph.py)

    # the port's own: where a run writes its spans and a short profiler
    # trace ('' = nowhere; train/runner.py:run)
    trace_dir: str = ""

    def __post_init__(self):
        if self.test_batch_size <= 0:
            self.test_batch_size = self.batch_size
        if self.save_feats:
            # reference: config_args.py:89-92
            self.pretrain = False
            self.shuffle_train = False
            self.epochs = 1

    # -- derived paths -----------------------------------------------------

    @property
    def dataset_dir(self) -> str:
        return os.path.join(self.dataroot, self.cell_type, self.window_size)

    @property
    def data_path(self) -> str:
        fname = "dataset_small.npz" if self.small else "dataset.npz"
        return os.path.join(self.dataset_dir, fname)

    @property
    def graph_root(self) -> str:
        return os.path.join(self.dataset_dir, "hic")

    def graph_path(self, split: str) -> str:
        # reference file contract: finetune.py:21
        return os.path.join(
            self.graph_root, f"{split}_graphs_{self.hicsize}_{self.hicnorm}norm.npz"
        )

    @property
    def stage1_id(self) -> str:
        """Pretrain-stage experiment ID (reference: config_args.py:70-86)."""
        parts = [
            "graph",
            self.window_model,
            str(self.d_model),
            f"bsz_{self.batch_size}",
            f"loss_{self.loss}",
            str(self.optim),
            "lr_" + str(self.lr).split(".")[1] if "." in str(self.lr) else f"lr_{self.lr}",
        ]
        name = ".".join(parts)
        if self.lr_decay > 0:
            name += f".decay_{str(self.lr_decay).replace('.', '')}_{self.lr_step_size}"
        name += ".drop_" + f"{self.dropout:.2f}".split(".")[1] + "_" + f"{self.dropout:.2f}".split(".")[1]
        if self.name:
            name += f".{self.name}"
        return name

    @property
    def experiment_id(self) -> str:
        """Full run ID; finetune runs append the GCN hparams
        (reference: config_args.py:93-115)."""
        name = self.stage1_id
        if self.load_pretrained and not self.save_feats:
            name += ".finetune"
            name += ".lr2_" + (str(self.lr2).split(".")[1] if "." in str(self.lr2) else str(self.lr2))
            name += ".gcndrop_" + f"{self.gcn_dropout:.2f}".split(".")[1]
            name += f".{self.optim2}"
            name += f".{self.chrome_model}"
            name += f".layers_{self.gcn_layers}"
            if self.chrome_model == "gcn" and self.gate:
                name += ".gate"
            if self.chrome_model == "gcn":
                name += f".adj_{self.adj_type}"
                if self.adj_type in ("hic", "both"):
                    name += f".norm_{self.hicnorm}"
            if self.lr_decay2 > 0:
                name += f".decay_{str(self.lr_decay2).replace('.', '')}_{self.lr_step_size2}"
            if self.name2:
                name += f".{self.name2}"
        return name

    @property
    def run_dir(self) -> str:
        return os.path.join(self.results_dir, self.cell_type, self.experiment_id)

    @property
    def stage1_run_dir(self) -> str:
        """Where the CNN checkpoint + saved features live — the CNN->GCN
        file-contract seam (reference: main.py:30-32, 72-77 uses
        model_name.split('.finetune')[0])."""
        return os.path.join(self.results_dir, self.cell_type, self.stage1_id)

    def feature_path(self, split: str) -> str:
        return os.path.join(self.stage1_run_dir, f"chrom_feature_dict_{split}.npz")

    # -- stage-2 hyperparameter routing ------------------------------------

    def gcn_optim_and_lr(self) -> Tuple[str, float]:
        """Reference behavior: GCN stage reuses optim/lr (the lr2/optim2
        flags are vestigial). Set use_stage2_hparams=True to route them."""
        if self.use_stage2_hparams:
            return self.optim2, self.lr2
        return self.optim, self.lr
