"""Plain PyTorch reference of the ChromeRNN chromosome step (Lanchantin & Qi,
Bioinformatics 2020; https://github.com/QData/ChromeGCN
models/ChromeModels.py:55-72, trained by the recipe of README.md:45 with
``-chrome_model rnn``), written from the configuration alone. It imports
nothing of the program, and no LSTM of torch's (``nn.LSTM``, ``torch._VF``):
the cell is written out from its equations.

Per strand, the chromosome's windows are one sequence through ``layers``
bidirectional LSTM layers of hidden H. A direction's step, gates in the
order i, f, g, o of the weights' rows:

    i, f, g, o = split(x W_ih^T + b_ih + h W_hh^T + b_hh)
    c = sigmoid(f) c + sigmoid(i) tanh(g)        h = sigmoid(o) tanh(c)

from h = c = 0; the reverse direction runs over the flipped sequence and
its outputs are flipped back; a layer's output is the two directions' h
side by side (forward first). Dropout between layers, then ReLU,
BatchNorm over the valid rows, dropout, and ``reference/gcn.py``'s head once
over the strands' mean and its mean binary cross-entropy with logits.

Departure from QData's torch code, which runs the unpadded chromosome: the
sequence is all N_pad rows, the valid windows followed by the zero rows the
runner pads (``traffic.node_inputs``), as the program and the JAX package
run it. So the reverse direction reads the padded suffix before the last
valid window, and each valid output depends on the node bucket.

Dropout masks are ``gcn.py``'s draws, of shape (N_pad, 2H), from one
generator in the order the program meets them: strand f's between the layers
and after BatchNorm, then strand r's.

For speed at a chromosome's size, each layer's input projection is one GEMM
over every position, and the recurrence runs the 2 strands x 2 directions
as one batch of 4 sequences, position after position; its backward is a
hand-written loop over the positions in reverse (``Recurrence``; on the
H100 autograd through the same loop took 3.8 times as long), whose weight
gradient is one GEMM over every position after it. Both loops run
in chunks of ``CHUNK`` positions, each chunk on the card a replay of a CUDA
graph of the same operations.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.reference import gcn


def param_specs(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, std) of every trained parameter, under the
    program's names (one single-layer ``rnn.{l}`` a layer)."""
    d, h, c = cfg["nfeat"], cfg["hidden"], cfg["nclass"]
    specs = []
    for layer in range(cfg["layers"]):
        fan_in = d if layer == 0 else 2 * h
        for suffix in ("", "_reverse"):
            specs += [
                (f"rnn.{layer}.weight_ih_l0{suffix}", (4 * h, fan_in), "normal",
                 math.sqrt(1.0 / fan_in)),
                (f"rnn.{layer}.weight_hh_l0{suffix}", (4 * h, h), "normal", math.sqrt(1.0 / h)),
                (f"rnn.{layer}.bias_ih_l0{suffix}", (4 * h,), "normal",
                 cfg["lstm_bias_std"]),
            ]
    specs += [
        ("batch_norm.weight", (2 * h,), "ones", 0.0),
        ("batch_norm.bias", (2 * h,), "zeros", 0.0),
        ("out.weight", (c, 2 * h), "normal", math.sqrt(1.0 / (2 * h))),
        ("out.bias", (c,), "zeros", 0.0),
    ]
    return specs


def fixed_specs(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """The LSTMs' second biases, ``bias_hh``: held, not trained (the
    program's LSTM has one trained bias a gate, as flax's cell)."""
    h = cfg["hidden"]
    return [(f"rnn.{layer}.bias_hh_l0{suffix}", (4 * h,), "normal", cfg["lstm_bias_std"])
            for layer in range(cfg["layers"]) for suffix in ("", "_reverse")]


# positions a chunk of the recurrence's loop runs; on the card each sweep
# captures the chunk's loop once as a CUDA graph and replays it, so the
# host's cost of launching a dozen small kernels a position leaves the serial
# loop
CHUNK = 1024


class _Chunks:
    """Runs ``body``, a chunk of the loop over static buffers, once a call:
    eagerly the first time (which also initialises what a capture must not
    see), on the card a replay of one graph captured from it after that."""

    def __init__(self, body, cuda: bool):
        self.body, self.cuda, self.graph, self.calls = body, cuda, None, 0

    def __call__(self) -> None:
        if not self.cuda or not self.calls:
            self.body()
        else:
            if self.graph is None:
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                    self.body()
            self.graph.replay()
        self.calls += 1


def _chunk_len(t_len: int, chunk: int) -> int:
    return chunk if 0 < chunk < t_len and t_len % chunk == 0 else t_len


def _sweep(gx: torch.Tensor, w_hh: torch.Tensor, chunk: int = CHUNK):
    """The recurrence over T positions of S sequences: ``gx`` (T, S, 4H)
    the input projections with both biases, ``w_hh`` (S, 4H, H) each
    sequence's recurrent weights. Returns the outputs h (T, S, H), the gates
    after their nonlinearities (T, S, 4H: sigmoid i, f, tanh g, sigmoid o)
    and the cells c (T, S, H). The loop runs ``chunk`` positions at a time
    (all T where ``chunk`` does not divide them), h and c carried between
    chunks."""
    t_len, s, four_h = gx.shape
    h, k_len = four_h // 4, _chunk_len(t_len, chunk)
    acts = gx.new_empty((t_len, s, 1, four_h))
    hs, cs = gx.new_empty((t_len, s, 1, h)), gx.new_empty((t_len, s, 1, h))
    # the chunk's buffers
    gx_k, acts_k = gx.new_empty((k_len, s, 1, four_h)), gx.new_empty((k_len, s, 1, four_h))
    hs_k, cs_k = gx.new_empty((k_len, s, 1, h)), gx.new_empty((k_len, s, 1, h))
    h_carry, c_carry = gx.new_zeros((s, 1, h)), gx.new_zeros((s, 1, h))
    gates, tanh_c = gx.new_empty((s, 1, four_h)), gx.new_empty((s, 1, h))
    act_i, act_f, act_g, act_o = (acts_k[..., k * h:(k + 1) * h] for k in range(4))
    pre_g, w_t = gates[..., 2 * h:3 * h], w_hh.transpose(1, 2)

    def body():
        h_prev, c_prev = h_carry, c_carry
        for k in range(k_len):
            torch.baddbmm(gx_k[k], h_prev, w_t, out=gates)
            torch.sigmoid(gates, out=acts_k[k])
            torch.tanh(pre_g, out=act_g[k])
            c = cs_k[k]
            torch.mul(act_f[k], c_prev, out=c)
            c.addcmul_(act_i[k], act_g[k])
            torch.tanh(c, out=tanh_c)
            torch.mul(act_o[k], tanh_c, out=hs_k[k])
            h_prev, c_prev = hs_k[k], c
        h_carry.copy_(h_prev)
        c_carry.copy_(c_prev)

    run, gx4 = _Chunks(body, gx.is_cuda), gx.unsqueeze(2)
    for t0 in range(0, t_len, k_len):
        gx_k.copy_(gx4[t0:t0 + k_len])
        run()
        for whole, part in ((acts, acts_k), (hs, hs_k), (cs, cs_k)):
            whole[t0:t0 + k_len].copy_(part)
    return hs.squeeze(2), acts.squeeze(2), cs.squeeze(2)


def _sweep_back(d_hs: torch.Tensor, w_hh: torch.Tensor, acts: torch.Tensor,
                cs: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """Backpropagation through ``_sweep``: the gradient of its gates before
    their nonlinearities (T, S, 4H), which is ``gx``'s, from the outputs'
    gradient ``d_hs`` (T, S, H). What does not carry from position to
    position is computed for all of them first; the loop runs in chunks
    from the last, the gradients of h and c carried between them."""
    t_len, s, four_h = acts.shape
    h, k_len = four_h // 4, _chunk_len(t_len, chunk)
    i, f, g, o = acts.view(t_len, s, 4, h).unbind(2)
    c_prev = torch.cat([cs.new_zeros((1, s, h)), cs[:-1]])
    tanh_c = torch.tanh(cs)
    whole = {
        "d_hs": d_hs.unsqueeze(2),
        "dh_to_dc": (o * (1 - tanh_c * tanh_c)).unsqueeze(2),     # dc += dh * this
        "dc_to_gates": torch.stack([g * i * (1 - i), c_prev * f * (1 - f), i * (1 - g * g)], 2),
        "dh_to_o": (tanh_c * o * (1 - o)).unsqueeze(2),
        "f": f.unsqueeze(2),
    }
    del i, g, o, c_prev, tanh_c
    part = {name: v.new_empty((k_len,) + v.shape[1:]) for name, v in whole.items()}
    d_gx = acts.new_empty((t_len, s, 1, four_h))
    d_gx_k = acts.new_empty((k_len, s, 1, four_h))
    d_ifg, d_o = d_gx_k.view(k_len, s, 4, h)[:, :, :3], d_gx_k[..., 3 * h:]
    d_hs_before = acts.new_zeros((s, 1, h))
    dh_carry, dc_carry = whole["d_hs"][t_len - 1].clone(), acts.new_zeros((s, 1, h))

    def body():
        dh, dc_next = dh_carry, dc_carry
        for k in range(k_len - 1, -1, -1):
            dc = torch.addcmul(dc_next, dh, part["dh_to_dc"][k])
            torch.mul(dc, part["dc_to_gates"][k], out=d_ifg[k])
            torch.mul(dh, part["dh_to_o"][k], out=d_o[k])
            dc_next = dc * part["f"][k]
            dh = torch.baddbmm(part["d_hs"][k - 1] if k else d_hs_before, d_gx_k[k], w_hh)
        dh_carry.copy_(dh)
        dc_carry.copy_(dc_next)

    run = _Chunks(body, acts.is_cuda)
    for t0 in range(t_len - k_len, -1, -k_len):
        for name, v in whole.items():
            part[name].copy_(v[t0:t0 + k_len])
        if t0:
            d_hs_before.copy_(whole["d_hs"][t0 - 1])
        run()
        d_gx[t0:t0 + k_len].copy_(d_gx_k)
    return d_gx.squeeze(2)


class Recurrence(torch.autograd.Function):
    """``_sweep``'s outputs h, differentiable in ``gx`` and ``w_hh``."""

    @staticmethod
    def forward(ctx, gx, w_hh, chunk=CHUNK):
        hs, acts, cs = _sweep(gx, w_hh, chunk)
        ctx.chunk = chunk
        ctx.save_for_backward(w_hh, hs, acts, cs)
        return hs

    @staticmethod
    def backward(ctx, d_hs):
        w_hh, hs, acts, cs = ctx.saved_tensors
        d_gx = _sweep_back(d_hs.contiguous(), w_hh, acts, cs, ctx.chunk)
        h_prev = torch.cat([hs.new_zeros((1,) + hs.shape[1:]), hs[:-1]])
        return d_gx, torch.einsum("tsg,tsh->sgh", d_gx, h_prev), None


def bilstm(w: Dict[str, torch.Tensor], fixed: Dict[str, torch.Tensor], layer: int,
           x: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """One bidirectional layer over ``x`` (T, S, d): S sequences (the
    strands), each direction one GEMM for the input projections, the 2 S
    recurrences as one batch (``Recurrence`` in chunks of ``chunk``).
    Returns (T, S, 2H)."""
    names = [f"rnn.{layer}.{{}}_l0{suffix}" for suffix in ("", "_reverse")]
    w_ih = torch.cat([w[n.format("weight_ih")] for n in names])
    bias = torch.cat([w[n.format("bias_ih")] + fixed[n.format("bias_hh")] for n in names])
    proj = x @ w_ih.t() + bias                                  # (T, S, 2 x 4H)
    four_h, s = proj.shape[-1] // 2, x.shape[1]
    gx = torch.cat([proj[..., :four_h], proj[..., four_h:].flip(0)], 1)
    w_hh = torch.stack([w[n.format("weight_hh")] for n in names for _ in range(s)])
    hs = Recurrence.apply(gx, w_hh, chunk)
    return torch.cat([hs[:, :s], hs[:, s:].flip(0)], -1)


def dropout_scales(cfg: dict, n_pad: int, dtype, device, gen: torch.Generator) -> List[list]:
    """Per strand, the dropout scales (0 or 1 / (1 - p), (N_pad, 2H)) in the
    order the program draws them: between the layers, then after
    BatchNorm."""
    ones = torch.ones((n_pad, 2 * cfg["hidden"]), dtype=dtype, device=device)
    return [[gcn._dropout(ones, cfg["dropout"], n_pad, gen) for _ in range(cfg["layers"])]
            for _ in range(cfg["strands"])]


def head_logits(cfg: dict, w, fixed, data: Dict[str, torch.Tensor], n_valid: int,
                gen: torch.Generator, stats: gcn.BatchNormStats) -> torch.Tensor:
    """The chromosome's logits over its valid rows, training: both strands
    through the layers, each through ReLU, BatchNorm (updating ``stats``,
    strand f first) and dropout, the head over their mean."""
    n_pad = data["x_f"].shape[0]
    scales = dropout_scales(cfg, n_pad, data["x_f"].dtype, data["x_f"].device, gen)
    x = torch.stack([data["x_f"], data["x_r"]], 1)                # (T, 2, d)
    for layer in range(cfg["layers"]):
        if layer:
            x = x * torch.stack([s[layer - 1] for s in scales], 1)
        x = bilstm(w, fixed, layer, x)
    feats = []
    for k, strand in enumerate(scales):
        h = torch.relu(x[:n_valid, k])
        mean = h.mean(0)
        var = (h - mean).square().mean(0)
        stats.update(mean, var, n_valid)
        h = (h - mean) * torch.rsqrt(var + cfg["batch_norm"]["eps"])
        h = h * w["batch_norm.weight"] + w["batch_norm.bias"]
        feats.append(h * strand[-1][:n_valid])
    return ((feats[0] + feats[1]) / 2.0) @ w["out.weight"].t() + w["out.bias"]


def loss_fn(cfg: dict, sets: List[Dict[str, torch.Tensor]], n_valid: int,
            fixed: Dict[str, torch.Tensor], dropout_seed: int, dtype, device,
            half_batch: bool = False):
    """``loss(w, i)``: step i's training loss on ``sets[i % len(sets)]``
    (``x_f`` and ``x_r`` of all N_pad rows, ``targets`` of the valid ones),
    cast to ``dtype``, with the dropout generator and BatchNorm statistics
    carried from step to step. ``half_batch`` takes the mean over the first
    half of the rows only (a planted fault)."""
    if cfg["strands"] != 2:
        raise ValueError("the head averages the two strands")
    gen = torch.Generator(device=device).manual_seed(dropout_seed)
    stats = gcn.BatchNormStats(2 * cfg["hidden"], cfg["batch_norm"]["momentum"], dtype, device)
    cast = [{k: v.to(dtype) for k, v in s.items()} for s in sets]
    held = {k: v.to(dtype) for k, v in fixed.items()}

    def loss(w, i):
        data = cast[i % len(cast)]
        logits = head_logits(cfg, w, held, data, n_valid, gen, stats)
        rows = n_valid // 2 if half_batch else n_valid
        return gcn.bce(logits[:rows], data["targets"][:rows])

    return loss

