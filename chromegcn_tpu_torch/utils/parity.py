"""Chromosome-scale parity harness: the original model's computation
(torch.sparse.mm) against the port's ChromeGCN (port of
chromegcn_tpu/utils/parity.py).

It builds a chr1-scale synthetic Hi-C graph, fabricates a checkpoint of the
original PyTorch ChromeGCN, carries it into the port
(utils/torch_port.py:port_chromegcn), runs the gated 2-layer forward through
the oracle (the reference's compute, models/SubLayers.py:46 torch.spmm, on
the CPU) and through the port's products ('xla': the COO path; 'pallas':
kernel B1 over the flat BSR form on the card), and reports per-layer
max-abs errors (GC1 / W1 / GC2 / W2 / batch_norm / logits) on the valid
rows. The port's model runs in f32 with TF32 off, as its steps do.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

LAYER_ORDER = ("GC1", "W1", "GC2", "W2", "batch_norm", "out")


def make_chromegcn_state(
    d: int, nclass: int, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Fabricate a torch-format ChromeGCN state_dict (the shapes/keys of
    reference models/ChromeModels.py:21-33) with non-trivial BN stats."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.1):
        return rng.normal(scale=scale, size=shape).astype(np.float32)

    return {
        # GraphConvolution stores (in, out) — reference models/SubLayers.py:12
        "GC1.weight": w(d, d), "GC1.bias": w(d),
        "W1.weight": w(1, d), "W1.bias": w(1),
        "GC2.weight": w(d, d), "GC2.bias": w(d),
        "W2.weight": w(1, d), "W2.bias": w(1),
        "batch_norm.weight": w(d, scale=1.0),
        "batch_norm.bias": w(d),
        "batch_norm.running_mean": w(d),
        "batch_norm.running_var": rng.uniform(0.5, 2.0, size=d).astype(np.float32),
        "out.weight": w(nclass, d), "out.bias": w(nclass),
    }


def torch_chromegcn_oracle(
    state: Mapping[str, np.ndarray],
    senders: np.ndarray,
    receivers: np.ndarray,
    vals: np.ndarray,
    n_nodes: int,
    x: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Eval-mode gated 2-layer forward with torch.sparse.mm, returning the
    per-layer activations named like the flax submodules (pre-activation
    outputs of GC1/W1/GC2/W2, the BN output, and the final logits) —
    reference equations: models/ChromeModels.py:34-52."""
    t = {k: torch.tensor(np.asarray(v)) for k, v in state.items()}
    idx = torch.tensor(
        np.stack([receivers, senders]).astype(np.int64), dtype=torch.int64
    )
    adj = torch.sparse_coo_tensor(
        idx, torch.tensor(np.asarray(vals)), (n_nodes, n_nodes),
        check_invariants=True,
    ).coalesce()
    xt = torch.tensor(np.asarray(x))
    acts: Dict[str, np.ndarray] = {}
    with torch.no_grad():
        z1 = torch.sparse.mm(adj, xt @ t["GC1.weight"]) + t["GC1.bias"]
        acts["GC1"] = z1.numpy()
        z = torch.tanh(z1)
        gl = z @ t["W1.weight"].T + t["W1.bias"]
        acts["W1"] = gl.numpy()
        g = torch.sigmoid(gl)
        xt = (1 - g) * xt + g * z

        z2p = torch.sparse.mm(adj, xt @ t["GC2.weight"]) + t["GC2.bias"]
        acts["GC2"] = z2p.numpy()
        z2 = torch.tanh(z2p)
        g2l = z2 @ t["W2.weight"].T + t["W2.bias"]
        acts["W2"] = g2l.numpy()
        g2 = torch.sigmoid(g2l)
        xt = (1 - g2) * xt + g2 * z2

        h = torch.relu(xt)
        h = (h - t["batch_norm.running_mean"]) / torch.sqrt(
            t["batch_norm.running_var"] + 1e-5
        )
        h = h * t["batch_norm.weight"] + t["batch_norm.bias"]
        acts["batch_norm"] = h.numpy()
        acts["out"] = (h @ t["out.weight"].T + t["out.bias"]).numpy()
    return acts


def framework_chromegcn_acts(
    state: Mapping[str, np.ndarray],
    graph,
    x: np.ndarray,
    impl: str,
    d: int,
    nclass: int,
) -> Dict[str, np.ndarray]:
    """Run the port's ChromeGCN (eval mode) with the carried-over checkpoint
    on the graph's device, and capture the same per-layer activations with
    forward hooks: the GC layers' and gates' pre-activation outputs, the
    BatchNorm's output and the logits."""
    from chromegcn_tpu_torch.models.chrome import ChromeGCN
    from chromegcn_tpu_torch.utils.torch_port import port_chromegcn

    torch.backends.cuda.matmul.allow_tf32 = False
    model = ChromeGCN(nfeat=d, nhid=d, nclass=nclass, dropout=0.0, layers=2, spmm_impl=impl)
    model.load_state_dict(port_chromegcn(dict(state)))
    model.to(graph.device)
    acts: Dict[str, np.ndarray] = {}
    handles = [
        getattr(model, name).register_forward_hook(
            lambda _m, _i, out, name=name: acts.__setitem__(name, out.detach().cpu().numpy()))
        for name in LAYER_ORDER[:-1]
    ]
    try:
        with torch.no_grad():
            _, logits, _ = model(torch.as_tensor(x, device=graph.device), graph, train=False)
    finally:
        for h in handles:
            h.remove()
    acts["out"] = logits.cpu().numpy()
    return acts


def chromegcn_chr_parity(
    n_valid: int,
    n_pad: int,
    n_pairs: int,
    d: int = 128,
    nclass: int = 919,
    impls: Sequence[str] = ("xla", "pallas"),
    seed: int = 0,
    device="cuda",
) -> Dict[str, Dict[str, float]]:
    """Build a chr-scale graph and checkpoint, run the oracle and the port's
    paths, return {impl: {layer: max_abs_err}} on the valid rows."""
    from chromegcn_tpu_torch.data.synthetic import make_hic_edges
    from chromegcn_tpu_torch.ops.sparse import build_chrom_graph
    from chromegcn_tpu_torch.ops.spmm_bsr import attach_bsr

    s, r, v = make_hic_edges(n_valid, n_pairs, seed=seed)
    graph = build_chrom_graph("hic", n_valid=n_valid, n_pad=n_pad, hic_edges=(s, r, v),
                              device=device)
    state = make_chromegcn_state(d, nclass, seed=seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(n_pad, d)).astype(np.float32)

    ne = int(graph.n_edges)
    oracle = torch_chromegcn_oracle(
        state,
        graph.senders[:ne].cpu().numpy(),
        graph.receivers[:ne].cpu().numpy(),
        graph.vals[:ne].cpu().numpy(),
        n_pad,
        x,
    )
    report: Dict[str, Dict[str, float]] = {}
    for impl in impls:
        g = attach_bsr(graph, device=device) if impl == "pallas" else graph
        acts = framework_chromegcn_acts(state, g, x, impl, d, nclass)
        report[impl] = {
            name: float(np.max(np.abs(acts[name][:n_valid] - oracle[name][:n_valid])))
            for name in LAYER_ORDER
        }
    return report
