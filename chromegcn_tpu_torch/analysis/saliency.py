"""Model interpretation: adjacency saliency, gate inspection, embeddings
(port of chromegcn_tpu/analysis/saliency.py).

- adjacency saliency: the gradient of a label's prediction with respect to
  the Hi-C edge values (the reference reads ``adj.grad``), through the COO
  product with the values as a leaf that requires grad;
- gate values: the per-node gates g1/g2 of the gated GCN;
- refined embeddings, and their t-SNE (sklearn, imported inside
  ``tsne_embeddings`` only);
- feature saliency: the gradient with respect to the input features,
  through the model's own product (kernel B1 and its backward on the card);
- TF-TF knockouts: in-silico contact knockouts through the COO product.

Each function takes a ChromeGCN (``models/chrome.py``) with its weights and
a graph on the model's device, runs it in eval mode (running BatchNorm
statistics, no dropout) and returns numpy arrays.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from chromegcn_tpu_torch.ops.sparse import SparseGraph, row_normalize


@contextlib.contextmanager
def _coo_path(model):
    """The model's products through the plain COO path (``impl='xla'``),
    which differentiates with respect to the edge values; restored after."""
    convs = [m for m in model.modules() if hasattr(m, "spmm_impl")]
    saved = [m.spmm_impl for m in convs]
    for m in convs:
        m.spmm_impl = "xla"
    try:
        yield model
    finally:
        for m, impl in zip(convs, saved):
            m.spmm_impl = impl


def _as_input(x, graph: SparseGraph) -> torch.Tensor:
    return torch.as_tensor(x, device=graph.device)


def adjacency_saliency(
    model, x, graph: SparseGraph, target_label: Optional[int] = None
) -> np.ndarray:
    """d(sum of logits, or of one label's) / d(edge values): one value per
    stored edge, aligned with graph.senders/receivers, (E_pad,)."""
    x = _as_input(x, graph)
    vals = graph.vals.detach().to(x.dtype).requires_grad_()
    plain = graph.replace(bsr=None, vals=vals)
    with _coo_path(model):
        _, logits, _ = model(x, plain, train=False)
    score = logits.sum() if target_label is None else logits[:, target_label].sum()
    (grad,) = torch.autograd.grad(score, vals)
    return grad.cpu().numpy()


@torch.no_grad()
def gate_values(model, x, graph: SparseGraph) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Per-node gate activations (g1, g2) of the gated GCN."""
    _, _, (g1, g2) = model(_as_input(x, graph), graph, train=False)
    return g1.cpu().numpy(), None if g2 is None else g2.cpu().numpy()


@torch.no_grad()
def refined_embeddings(model, x, graph: SparseGraph) -> np.ndarray:
    """Post-GCN node embeddings (before the head), e.g. for t-SNE."""
    x_out, _, _ = model(_as_input(x, graph), graph, train=False)
    return x_out.cpu().numpy()


def feature_saliency(model, x, graph: SparseGraph, target_label: int) -> np.ndarray:
    """d(sum of one label's logits) / d(input features) (the reference sets
    x_f.requires_grad; reference: finetune.py:33-34)."""
    x = _as_input(x, graph).detach().requires_grad_()
    _, logits, _ = model(x, graph, train=False)
    (grad,) = torch.autograd.grad(logits[:, target_label].sum(), x)
    return grad.cpu().numpy()


@torch.no_grad()
def tf_knockout_matrix(
    model, x_f, x_r, graph: SparseGraph, targets: np.ndarray, label_indices
) -> np.ndarray:
    """TF-TF interaction matrix by in-silico contact knockouts (reference:
    scripts/visualize.py, TF-TF section).

    For each label pair (i, j): zero every Hi-C edge whose source window is
    positive for both i and j, re-row-normalize, run the GCN on both
    strands, and record the relative drop of label i's mean probability over
    its positive windows, ``(mean_i - mean_ij) / mean_i``. Returns an (L, L)
    matrix in ``label_indices`` order, 0 where i == j or a label has no
    positive window."""
    label_indices = list(label_indices)
    targets = np.asarray(targets)
    x_f, x_r = _as_input(x_f, graph), _as_input(x_r, graph)
    plain = graph.replace(bsr=None)
    binary = (plain.vals > 0).to(plain.vals.dtype)
    senders = plain.senders.cpu().numpy()

    def predict(vals):
        g = row_normalize(plain.replace(vals=vals))
        with _coo_path(model):
            _, logit_f, _ = model(x_f, g, train=False)
            _, logit_r, _ = model(x_r, g, train=False)
        return torch.sigmoid((logit_f + logit_r) / 2.0).cpu().numpy()

    base_probs = predict(binary)
    n = len(label_indices)
    out = np.zeros((n, n), np.float32)
    for a, y_i in enumerate(label_indices):
        i_pos = targets[:, y_i] > 0
        if not i_pos.any():
            continue
        base_i = float(base_probs[i_pos, y_i].mean())
        if base_i == 0.0:
            continue
        sender_i = i_pos[senders]
        for b, y_j in enumerate(label_indices):
            if y_i == y_j:
                continue
            j_pos = targets[:, y_j] > 0
            if not j_pos.any():
                continue
            keep = torch.as_tensor(~(sender_i & j_pos[senders]), device=binary.device)
            ko_i = float(predict(binary * keep)[i_pos, y_i].mean())
            out[a, b] = (base_i - ko_i) / base_i
    return out


def tsne_embeddings(embeddings: np.ndarray, **tsne_kwargs) -> np.ndarray:
    """2-D t-SNE of refined node embeddings (reference: scripts/visualize.py,
    t-SNE section). Needs scikit-learn, which nothing else of the port does."""
    from sklearn.manifold import TSNE

    kwargs = {"n_components": 2, "init": "pca", "random_state": 0}
    kwargs.update(tsne_kwargs)
    return TSNE(**kwargs).fit_transform(np.asarray(embeddings))
