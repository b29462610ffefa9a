"""Carry weights across from the JAX package.

``chromegcn_state_dict`` turns a JAX ChromeGCN state (its ``params`` and
``batch_stats`` trees, as numpy arrays) into this port's ``state_dict``:
flax Dense kernels (in, out) become torch Linear weights (out, in);
``GC*.weight`` stays (in, out), as the reference's GraphConvolution stores
it (reference: models/SubLayers.py:12).

``window_state_dict`` does the same for a window model wrapped in
NonStrandSpecific (Expecto, DeepSEA or DanQ, as ``create_window_state``
makes them); its docstring lists the layout changes.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def unflatten_dense_kernel(k: np.ndarray, channels: int) -> np.ndarray:
    """The first Dense after the flatten, from a length-major (L C) flatten to
    a channel-major (C L) one: flax kernel (L C, out) -> torch weight
    (out, C L). The inverse of chromegcn_tpu/utils/torch_port.py:
    flatten_dense_kernel."""
    k = np.asarray(k)
    length = k.shape[0] // channels
    w = k.reshape(length, channels, -1)           # (L, C, out)
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)).reshape(k.shape[1], -1))


def _lstm_direction(cell: Mapping) -> Dict[str, np.ndarray]:
    """flax OptimizedLSTMCell params (input gates ``ii, if, ig, io`` without
    bias, hidden gates ``hi, hf, hg, ho`` with one) -> torch's packed
    (4H, in) / (4H, H) weights in gate order i, f, g, o, ``bias_ih`` the
    hidden gates' biases and ``bias_hh`` zero. The inverse of
    chromegcn_tpu/utils/torch_port.py:lstm_cell."""
    gates = ("i", "f", "g", "o")
    bias = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in gates])
    return {
        "weight_ih": np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]).T for g in gates]),
        "weight_hh": np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]).T for g in gates]),
        "bias_ih": bias,
        "bias_hh": np.zeros_like(bias),
    }


def window_state_dict(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX NonStrandSpecific window state (``params`` and ``batch_stats``
    as ``create_window_state`` makes them, numpy arrays under ``model``) ->
    the port's NonStrandSpecific ``state_dict``, for all three models:

    - Conv kernels (k, in, out) -> Conv1d weights (out, in, k);
    - Dense kernels are transposed; the first one after the flatten
      (``linear``) also has its rows permuted (``unflatten_dense_kernel``);
      DanQ's flatten is position-major in both, so ``linear1`` is only
      transposed;
    - BatchNorm ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
      ``running_mean``/``running_var`` (``num_batches_tracked`` 0);
    - DanQ's cells ``OptimizedLSTMCell_{0..3}`` (forward and backward of
      layer 0, then of layer 1) -> ``bilstm.weight_ih_l{k}[_reverse]`` etc.
    """
    p = params["model"]
    stats = batch_stats.get("model", {}) if batch_stats else {}
    out: Dict[str, torch.Tensor] = {"model.embed.weight": _t(p["embed"]["embedding"])}
    for name, layer in p.items():
        if name.startswith("conv"):
            out[f"model.{name}.weight"] = _t(np.transpose(np.asarray(layer["kernel"]), (2, 1, 0)))
            out[f"model.{name}.bias"] = _t(layer["bias"])
        elif name == "linear":
            out["model.linear.weight"] = _t(unflatten_dense_kernel(layer["kernel"], 960))
            out["model.linear.bias"] = _t(layer["bias"])
        elif name in ("classifier", "linear1", "linear2"):
            out[f"model.{name}.weight"] = _t(np.asarray(layer["kernel"]).T)
            out[f"model.{name}.bias"] = _t(layer["bias"])
        elif name.startswith("bn") or name == "head_bn":
            out[f"model.{name}.weight"] = _t(layer["scale"])
            out[f"model.{name}.bias"] = _t(layer["bias"])
            out[f"model.{name}.running_mean"] = _t(stats[name]["mean"])
            out[f"model.{name}.running_var"] = _t(stats[name]["var"])
            out[f"model.{name}.num_batches_tracked"] = torch.tensor(0)
        elif name == "bilstm":
            for i in range(len(layer)):
                suffix = f"l{i // 2}" + ("_reverse" if i % 2 else "")
                for key, value in _lstm_direction(layer[f"OptimizedLSTMCell_{i}"]).items():
                    out[f"model.bilstm.{key}_{suffix}"] = _t(value)
        elif name != "embed":
            raise KeyError(f"unknown window layer {name!r}")
    return out


def chromegcn_state_dict(
    params: Mapping, batch_stats: Mapping
) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name in ("GC1", "GC2"):
        if name in params:
            out[f"{name}.weight"] = _t(params[name]["weight"])
            out[f"{name}.bias"] = _t(params[name]["bias"])
    for name in ("W1", "W2", "out"):
        if name in params:
            out[f"{name}.weight"] = _t(np.asarray(params[name]["kernel"]).T)
            out[f"{name}.bias"] = _t(params[name]["bias"])
    out["batch_norm.weight"] = _t(params["batch_norm"]["scale"])
    out["batch_norm.bias"] = _t(params["batch_norm"]["bias"])
    out["batch_norm.running_mean"] = _t(batch_stats["batch_norm"]["mean"])
    out["batch_norm.running_var"] = _t(batch_stats["batch_norm"]["var"])
    return out
