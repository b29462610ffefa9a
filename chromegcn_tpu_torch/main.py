"""CLI entry point of the PyTorch/CUDA port (port of chromegcn_tpu/main.py).

The parser is the JAX package's, flag for flag (choices and defaults
included), so a command line carries over. The port runs the reference's
three modes on the card, one after the other:

    python -m chromegcn_tpu_torch.main -pretrain -window_model expecto ...
    python -m chromegcn_tpu_torch.main -save_feats -window_model expecto ...
    python -m chromegcn_tpu_torch.main -load_pretrained -chrome_model gcn \
        -adj_type hic -gcn_fused on ...

The first trains the window CNN on the dataset file, the second dumps its
features, and the third trains the GCN on them, its head warm-started from
the CNN's checkpoint.

Modes the port lacks raise NotImplementedError naming their ROADMAP item
(train/runner.py). ``main(argv, device="cpu")`` runs the plain PyTorch
path on the CPU, as the tests do.
"""

from __future__ import annotations

import argparse
import dataclasses

from chromegcn_tpu_torch.config import Config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="ChromeGCN (PyTorch/CUDA port): chromosome-scale epigenomic prediction",
        prefix_chars="-",
    )
    defaults = Config()
    # single-dash long flags for reference CLI compatibility
    p.add_argument("-dataroot", type=str, default=defaults.dataroot)
    p.add_argument("-results_dir", type=str, default=defaults.results_dir)
    p.add_argument("-cell_type", type=str, default=defaults.cell_type)
    p.add_argument("-window_size", type=str, default=defaults.window_size)
    p.add_argument("-epochs", type=int, default=defaults.epochs)
    p.add_argument("-batch_size", type=int, default=defaults.batch_size)
    p.add_argument("-test_batch_size", type=int, default=-1)
    p.add_argument("-d_model", type=int, default=defaults.d_model)
    p.add_argument("-optim", choices=["adam", "sgd"], default=defaults.optim)
    p.add_argument("-optim2", choices=["adam", "sgd"], default=defaults.optim2)
    p.add_argument("-lr", type=float, default=defaults.lr)
    p.add_argument("-lr2", type=float, default=defaults.lr2)
    p.add_argument("-weight_decay", type=float, default=defaults.weight_decay)
    p.add_argument("-lr_decay", type=float, default=defaults.lr_decay)
    p.add_argument("-lr_step_size", type=int, default=defaults.lr_step_size)
    p.add_argument("-lr_decay2", type=float, default=defaults.lr_decay2)
    p.add_argument("-lr_step_size2", type=int, default=defaults.lr_step_size2)
    p.add_argument("-dropout", type=float, default=defaults.dropout)
    p.add_argument("-gcn_dropout", type=float, default=defaults.gcn_dropout)
    p.add_argument("-save_mode", choices=["all", "best"], default=defaults.save_mode)
    p.add_argument(
        "-window_model", choices=["deepsea", "expecto", "danq"],
        default=defaults.window_model,
    )
    p.add_argument("-loss", choices=["ce"], default=defaults.loss)
    p.add_argument("-br_threshold", type=float, default=defaults.br_threshold)
    p.add_argument("-shuffle_train", action="store_true")
    p.add_argument("-pretrain", action="store_true")
    p.add_argument("-small", action="store_true")
    p.add_argument("-overwrite", action="store_true")
    p.add_argument("-test_only", action="store_true")
    p.add_argument("-load_pretrained", action="store_true")
    p.add_argument("-seq_length", type=int, default=defaults.seq_length)
    p.add_argument("-gcn_layers", type=int, default=defaults.gcn_layers)
    p.add_argument("-save_feats", action="store_true")
    p.add_argument("-chrome_model", choices=["gcn", "rnn"], default=defaults.chrome_model)
    p.add_argument(
        "-adj_type", choices=["constant", "hic", "both", "none"],
        default=defaults.adj_type,
    )
    p.add_argument("-hicnorm", choices=["KR", "VC", "SQRTVC", ""], default=defaults.hicnorm)
    p.add_argument(
        "-hicsize", choices=["125000", "250000", "500000", "1000000"],
        default=defaults.hicsize,
    )
    p.add_argument("-gate", action="store_true", default=True)
    p.add_argument("-no_gate", dest="gate", action="store_false")
    p.add_argument("-load_gcn", action="store_true")
    p.add_argument("-joint", action="store_true")
    p.add_argument("-joint_chunk", type=int, default=128)
    p.add_argument("-resume", action="store_true")
    p.add_argument("-name", type=str, default=None)
    p.add_argument("-name2", type=str, default=None)
    p.add_argument("-seed", type=int, default=defaults.seed)
    p.add_argument("-spmm_impl", choices=["auto", "xla", "pallas"], default="auto")
    p.add_argument("-spmm_dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument(
        "-spmm_form", choices=["auto", "bsr", "hybrid"], default="auto",
        help="block-sparse operator form: cost-model auto, BSR tiles+strips, "
        "or hybrid tiles + sorted-gather stragglers (ultra-sparse graphs)",
    )
    p.add_argument(
        "-gcn_fused", choices=["off", "on"], default="off",
        help="fused gated-GCN-layer kernels: the SpMM with the layer's GEMM "
        "in its epilogue (ops/gcn_fused.py)",
    )
    p.add_argument(
        "-matmul_precision", choices=["high", "highest", "default"],
        default=defaults.matmul_precision,
    )
    p.add_argument("-use_stage2_hparams", action="store_true")
    p.add_argument(
        "-early_stop_patience", type=int, default=0,
        help="stop after N epochs without valid selection-score improvement "
        "(0 = off, the reference's fixed-budget behavior)",
    )
    p.add_argument("-dp_devices", type=int, default=1)
    p.add_argument("-graph_devices", type=int, default=1)
    p.add_argument("-tp_devices", type=int, default=1)
    p.add_argument(
        "-graph_strategy",
        choices=["auto", "halo_bsr", "halo", "all_gather"],
        default="auto",
    )
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    fields = {f.name for f in dataclasses.fields(Config)}
    kwargs = {k: v for k, v in vars(args).items() if k in fields}
    return Config(**kwargs)


def main(argv=None, device=None) -> None:
    """Parse ``argv`` and run; ``device`` defaults to the card."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    print(cfg.run_dir)
    from chromegcn_tpu_torch.train.runner import run

    _, tracker = run(cfg, device=device)
    print(tracker.summary())


if __name__ == "__main__":
    main()
