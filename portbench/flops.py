"""Operations and bytes of the work a cell asks for, counted from the
configuration's shapes, and the card's published peaks.

Nothing is read from the program: no hook on its modules, no count of what
it recomputes. A later kernel that does the same work in fewer operations
does not change these numbers; one that does more shows as a lower share.
"""

from __future__ import annotations

from typing import List

# NVIDIA H100 SXM, data sheet, dense: HBM bytes/s, and the fastest
# f32-faithful GEMM rate, 3xTF32 (three TF32 products, 495 TFLOP/s, per f32
# one), which the configurations' float32 asks for
HBM_BYTES_PER_S = 3.35e12
F32_FAITHFUL_FLOPS = 495e12 / 3


def gcn_step_flops(cfg: dict, n_valid: int, nnz: int) -> float:
    """Forward and backward operations of one ``chrome_train_step`` over
    ``n_valid`` windows and ``nnz`` nonzeros of the normalised adjacency
    (contacts both ways and the self-loops): per strand and layer the
    N x d x d GEMM, the per-node scalar gate and one sparse product, the
    backward's weight and input gradients of each (none for the first
    layer's input, which is data), and the head once over the
    strand-averaged features."""
    n, d, c = n_valid, cfg["nhid"], cfg["nclass"]
    if cfg["nfeat"] != d:
        raise ValueError("the gated residual needs nfeat == nhid")
    gemm, spmm, gate = 2 * n * d * d, 2 * nnz * d, 2 * n * d
    per_strand = 0
    for layer in range(cfg["layers"]):
        forward = gemm + spmm + gate
        backward = gemm * (1 if layer == 0 else 2) + spmm + 2 * gate
        per_strand += forward + backward
    head = 3 * 2 * n * d * c
    return float(cfg["strands"] * per_strand + head)


def window_forward_macs(cfg: dict) -> List[int]:
    """Multiply-adds of one sequence's forward, per layer of the
    configuration's ``layers`` list (lengths carried through the valid
    convolutions and floor pools); the embedding is a lookup."""
    length, channels, flat, macs = cfg["seq_length"], None, None, []
    for layer in cfg["layers"]:
        op = layer["op"]
        if op == "embed":
            channels = layer["dim"]
        elif op == "conv":
            if layer["in"] != channels:
                raise ValueError(f"{layer['name']}: {channels} channels come in")
            length = length - layer["k"] + 1
            macs.append(length * layer["out"] * layer["in"] * layer["k"])
            channels = layer["out"]
        elif op == "maxpool":
            length //= layer["k"]
        elif op == "flatten":
            flat = channels * length
        elif op == "linear":
            fan_in = flat if layer["in"] == "flat" else layer["in"]
            macs.append(fan_in * layer["out"])
            flat = layer["out"]
    return macs


def window_step_flops(cfg: dict) -> float:
    """Forward and backward operations of one ``window_train_step``: both
    strands of ``batch_size`` sequences, each layer's forward and its weight
    and input gradients (the embedding's weight trains, so every layer needs
    its input gradient): three times the forward's 2 x multiply-adds."""
    per_sequence = 2 * sum(window_forward_macs(cfg))
    return float(3 * per_sequence * cfg["strands"] * cfg["batch_size"])


def spmm_bytes(n_rows: int, nnz: int, d: int, value_bytes: int = 4, x_bytes: int = 4) -> int:
    """Bytes the logical operator out = A @ x needs, whatever form or kernel
    runs it: each nonzero's value and 4-byte column, the n_rows + 1 row
    pointers, x read once and out written once."""
    return nnz * (value_bytes + 4) + 4 * (n_rows + 1) + 2 * n_rows * d * x_bytes


def spmm_bound_s(n_rows: int, nnz: int, d: int) -> float:
    """Least seconds of one f32 product at HBM bandwidth (its operations,
    2 nnz d, are far below the FFMA peak's share of that time)."""
    return spmm_bytes(n_rows, nnz, d) / HBM_BYTES_PER_S
