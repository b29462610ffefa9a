"""Chord diagrams of chromosome-scale interactions.

Replaces reference scripts/plot_chord.py (395 LoC of hand-rolled Bézier
matplotlib): circular layout of a chromosome's windows with arcs for Hi-C
contacts, colorable by gate weight or adjacency saliency. Port of
chromegcn_tpu/analysis/chord.py; matplotlib is imported inside.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from chromegcn_tpu_torch.ops.sparse import SparseGraph


def chord_plot(
    graph: SparseGraph,
    edge_values: Optional[np.ndarray] = None,
    node_values: Optional[np.ndarray] = None,
    max_edges: int = 2000,
    title: str = "",
    out_path: Optional[str] = None,
):
    """Draw a chord diagram of the strongest edges.

    Args:
      graph: chromosome adjacency (COO).
      edge_values: per-edge color weights (e.g. saliency from
        analysis.saliency.adjacency_saliency); defaults to graph.vals.
      node_values: optional per-node color (e.g. gate activations).
      max_edges: plot only the top-|value| edges.
      out_path: if given, save a PNG instead of returning the figure.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.path import Path
    import matplotlib.patches as patches

    senders = graph.senders.cpu().numpy()
    receivers = graph.receivers.cpu().numpy()
    vals = np.asarray(edge_values) if edge_values is not None else graph.vals.cpu().numpy()
    n_valid = graph.n_valid_nodes

    real = (vals != 0) & (senders != receivers)
    senders, receivers, vals = senders[real], receivers[real], vals[real]
    if len(vals) > max_edges:
        top = np.argsort(np.abs(vals))[-max_edges:]
        senders, receivers, vals = senders[top], receivers[top], vals[top]

    theta = 2 * np.pi * np.arange(n_valid) / max(n_valid, 1)
    xy = np.stack([np.cos(theta), np.sin(theta)], axis=1)

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.set_aspect("equal")
    ax.axis("off")
    if title:
        ax.set_title(title)

    vmax = np.abs(vals).max() if len(vals) else 1.0
    cmap = plt.get_cmap("coolwarm")
    order = np.argsort(np.abs(vals))
    for e in order:
        i, j = int(receivers[e]), int(senders[e])
        if i >= n_valid or j >= n_valid:
            continue
        p0, p2 = xy[i], xy[j]
        # quadratic Bézier through the circle center region
        verts = [tuple(p0), (0.0, 0.0), tuple(p2)]
        path = Path(verts, [Path.MOVETO, Path.CURVE3, Path.CURVE3])
        color = cmap(0.5 + 0.5 * vals[e] / vmax)
        ax.add_patch(
            patches.PathPatch(
                path, facecolor="none", edgecolor=color,
                lw=0.5, alpha=min(1.0, 0.2 + 0.8 * abs(vals[e]) / vmax),
            )
        )

    if node_values is not None:
        nv = np.asarray(node_values).reshape(-1)[:n_valid]
        sc = ax.scatter(
            xy[:, 0], xy[:, 1], c=nv, s=4, cmap="viridis", zorder=3
        )
        fig.colorbar(sc, ax=ax, shrink=0.6)
    else:
        ax.scatter(xy[:, 0], xy[:, 1], s=2, color="black", zorder=3)

    if out_path:
        fig.savefig(out_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig
