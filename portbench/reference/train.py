"""The reference's optimizer loop and the numbers a training cell compares.

``sgd_steps`` follows the program through its first steps from the same
weights: SGD with momentum and L2 weight decay as torch.optim.SGD defines
them (d = g + wd p; buf = d on the first step, else momentum buf + d;
p -= lr buf). It records each step's loss, the first step's d per leaf (the
gradient as the optimizer gets it) and each leaf's change after the steps.

``gaps`` compares two such records: each step's loss, and per leaf the gap
between the two norms, as a share of the reference's norm of that leaf or
of the median leaf, whichever is larger. A leaf whose first gradient the
reference finds under a thousandth of the median leaf's is left out of the
change (it moves by round-off alone).
"""

from __future__ import annotations

import statistics
from typing import Callable, Dict, List, Optional

import torch

# a leaf moves by round-off alone below this share of the median leaf's
# first gradient
NOUGHT = 1e-3


def sgd_steps(weights: Dict[str, torch.Tensor], loss: Callable, opt: dict, steps: int,
              dtype, tf32: bool = False, observe: Optional[Callable] = None) -> dict:
    """``steps`` SGD steps of ``loss(w, i)`` from ``weights`` cast to
    ``dtype`` (TF32 matmuls when ``tf32``); ``observe(w, i)`` after step i
    may return a number to record. Returns {'losses', 'grad1', 'change',
    'observed'}."""
    if opt["name"] != "sgd":
        raise ValueError(f"the reference follows SGD only, not {opt['name']!r}")
    w = {k: v.detach().to(dtype).clone().requires_grad_() for k, v in weights.items()}
    start = {k: v.detach().clone() for k, v in w.items()}
    bufs: Dict[str, torch.Tensor] = {}
    losses, grad1, observed = [], {}, []
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for i in range(steps):
            value = loss(w, i)
            grads = torch.autograd.grad(value, list(w.values()))
            losses.append(float(value.detach()))
            with torch.no_grad():
                for (name, p), g in zip(w.items(), grads):
                    d = g + opt["weight_decay"] * p
                    bufs[name] = d.clone() if i == 0 else opt["momentum"] * bufs[name] + d
                    if i == 0:
                        grad1[name] = float(d.double().norm())
                    p -= opt["lr"] * bufs[name]
            if observe is not None:
                observed.append(observe(w, i))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    change = {k: float((w[k].detach() - start[k]).double().norm()) for k in w}
    return {"losses": losses, "grad1": grad1, "change": change, "observed": observed}


def leaf_gaps(ours: Dict[str, float], ref: Dict[str, float], names: List[str]) -> Dict[str, float]:
    """Each leaf's gap of norms over its or the median leaf's reference norm."""
    median = statistics.median(ref[n] for n in names)
    return {n: abs(ours[n] - ref[n]) / max(ref[n], median) for n in names}


def pred_gap(ours: List[list], ref: List[list]) -> float:
    """The largest absolute gap between two records' predictions, epoch by
    epoch and split by split."""
    if [len(e) for e in ours] != [len(e) for e in ref]:
        raise ValueError("the two records hold predictions of other epochs or splits")
    return max(float((torch.as_tensor(a, device=b.device, dtype=b.dtype) - b).abs().max())
               for epoch_a, epoch_b in zip(ours, ref) for a, b in zip(epoch_a, epoch_b))


def gaps(program: dict, ref: dict) -> Dict[str, float]:
    """Every number a training cell may compare (its limits name those it
    does): ``loss_gap``, the largest relative gap of a step's loss (and of
    any ``observed`` loss), and ``loss1_gap``, the first step's;
    ``grad_gap`` and ``change_gap``, the worst leaf's, as the module doc
    says, and ``median_change_gap``, the median leaf's; where the reference
    made predictions after its steps, ``pred_gap``."""
    pairs = list(zip(program["losses"], ref["losses"]))
    pairs += list(zip(program.get("observed", []), ref.get("observed", [])))
    names = sorted(ref["grad1"])
    if sorted(program["grad1"]) != names or sorted(program["change"]) != names:
        raise ValueError(f"the program trains {sorted(program['grad1'])}, the reference {names}")
    median = statistics.median(ref["grad1"][n] for n in names)
    moving = [n for n in names if ref["grad1"][n] >= NOUGHT * median]
    change = list(leaf_gaps(program["change"], ref["change"], moving).values())
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in pairs),
           "loss1_gap": abs(pairs[0][0] - pairs[0][1]) / abs(pairs[0][1]),
           "grad_gap": max(leaf_gaps(program["grad1"], ref["grad1"], names).values()),
           "change_gap": max(change),
           "median_change_gap": statistics.median(change)}
    if "preds" in ref:
        out["pred_gap"] = pred_gap(program["preds"], ref["preds"])
    return out
