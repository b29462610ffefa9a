"""What the loops share: the benchmark's weights, handed to the program's
model by name, and the program's side of the training check read from its
optimizer state."""

from __future__ import annotations

import math
import time
from typing import Dict, List, Tuple

import torch

from portbench import timing
from portbench.reference import train


def make_weights(specs: List[Tuple[str, tuple, str, float]], gen: torch.Generator,
                 device) -> Dict[str, torch.Tensor]:
    """float32 weights for ``specs`` (name, shape, kind, std): one draw of
    standard normals on ``device``, cut at two deviations, scaled per leaf."""
    sizes = [math.prod(shape) for _, shape, kind, _ in specs if kind == "normal"]
    noise = torch.randn(sum(sizes), generator=gen, device=device).clamp_(-2.0, 2.0)
    weights, at = {}, 0
    for name, shape, kind, std in specs:
        if kind == "normal":
            n = math.prod(shape)
            weights[name] = (noise[at:at + n] * std).view(shape)
            at += n
        elif kind == "ones":
            weights[name] = torch.ones(shape, device=device)
        else:
            weights[name] = torch.zeros(shape, device=device)
    return weights


def trained(module: torch.nn.Module, prefix: str = "") -> Dict[str, torch.nn.Parameter]:
    """The module's trained parameters by name, ``prefix`` taken off."""
    return {name[len(prefix):]: p for name, p in module.named_parameters()
            if p.requires_grad and name.startswith(prefix)}


def load_weights(module: torch.nn.Module, weights: Dict[str, torch.Tensor],
                 prefix: str = "") -> None:
    """Copy ``weights`` into the module's trained parameters of the same
    names; every trained parameter has to be given, in its shape."""
    params = trained(module, prefix)
    if sorted(params) != sorted(weights):
        raise ValueError(f"the model trains {sorted(params)}, the weights are {sorted(weights)}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: {tuple(p.shape)} against {tuple(weights[name].shape)}")
            p.copy_(weights[name])


def first_gradients(module, optimizer, prefix: str = "") -> Dict[str, float]:
    """Each leaf's gradient as SGD took it on its first step: the momentum
    buffer after that step (0 where the optimizer holds none)."""
    out = {}
    for name, p in trained(module, prefix).items():
        buf = optimizer.state.get(p, {}).get("momentum_buffer")
        out[name] = 0.0 if buf is None else float(buf.double().norm())
    return out


def changes(module, start: Dict[str, torch.Tensor], prefix: str = "") -> Dict[str, float]:
    """Each leaf's distance from ``start``."""
    return {name: float((p.detach() - start[name]).double().norm())
            for name, p in trained(module, prefix).items()}


class StepSession:
    """A closed loop of optimizer steps: ``setup`` builds the program's
    train state and runs its first ``CHECKED`` steps (the warm-up, and what
    the reference follows), then ``run`` times steps back to back for the
    measured seconds and, traced, profiles ``PROFILED_STEPS`` more.
    Subclasses give ``setup`` (filling ``program``, the program's side of
    the check), ``step(i)`` and ``reference``."""

    CHECKED = 3
    PROFILED_STEPS = 10

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.program: dict = {}

    def run(self, seconds: float, trace: bool, t_start: float) -> dict:
        self.setup()
        setup_s = time.perf_counter() - t_start
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        loop = timing.closed_loop(lambda i: self.step(self.CHECKED + i), seconds, self.device)
        peak = (torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda"
                else 0)
        self.step_ms = loop["seconds"] * 1e3 / loop["steps"]
        metrics = {"train_step_ms": self.step_ms,
                   "train_step_p95_ms": timing.p95(loop["gaps_ms"])}
        self.trace = None
        if trace:
            after = self.CHECKED + loop["steps"]

            def stretch():
                for i in range(self.PROFILED_STEPS):
                    self.step(after + i)
            self.trace = timing.profile(stretch, self.device)
        return {"setup_s": setup_s, "metrics": metrics, "attempted": loop["steps"],
                "failed": 0, "peak_bytes": peak}

    def numbers(self, ref: dict) -> Dict[str, float]:
        """The cell's numbers against the reference's record ``ref``."""
        return train.gaps(self.program, ref)

    def check(self, limits: Dict[str, float]) -> Tuple[bool, list]:
        return judge(self.numbers(self.reference(torch.float64)), limits)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, list]:
    """(correct, [[name, value, limit], ...]) over the numbers the cell's
    ``limits`` name: correct when there is one at least and each is finite
    and at most its limit."""
    rows = [[name, numbers[name], limit] for name, limit in limits.items()]
    ok = bool(rows) and all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
