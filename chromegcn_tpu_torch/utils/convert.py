"""Carry weights across from the JAX package.

``chromegcn_state_dict`` turns a JAX ChromeGCN state (its ``params`` and
``batch_stats`` trees, as numpy arrays) into this port's ``state_dict``:
flax Dense kernels (in, out) become torch Linear weights (out, in);
``GC*.weight`` stays (in, out), as the reference's GraphConvolution stores
it (reference: models/SubLayers.py:12).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def chromegcn_state_dict(
    params: Mapping, batch_stats: Mapping
) -> Dict[str, torch.Tensor]:
    def t(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32))

    out: Dict[str, torch.Tensor] = {}
    for name in ("GC1", "GC2"):
        if name in params:
            out[f"{name}.weight"] = t(params[name]["weight"])
            out[f"{name}.bias"] = t(params[name]["bias"])
    for name in ("W1", "W2", "out"):
        if name in params:
            out[f"{name}.weight"] = t(np.asarray(params[name]["kernel"]).T)
            out[f"{name}.bias"] = t(params[name]["bias"])
    out["batch_norm.weight"] = t(params["batch_norm"]["scale"])
    out["batch_norm.bias"] = t(params["batch_norm"]["bias"])
    out["batch_norm.running_mean"] = t(batch_stats["batch_norm"]["mean"])
    out["batch_norm.running_var"] = t(batch_stats["batch_norm"]["var"])
    return out
