"""Profiling and throughput counters (port of
chromegcn_tpu/utils/profiling.py).

- ``trace``: a ``torch.profiler`` trace of the enclosed block (host and
  card), written as a Chrome trace (``trace.json``, for Perfetto or
  chrome://tracing) under ``log_dir``;
- ``Throughput``: EMA rate counters keyed by unit ('edges', 'windows');
- ``block_on``: wait for a result by reading one number of it back.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed block with torch.profiler (CPU, and CUDA where
    there is a card) into ``log_dir/trace.json``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Throughput:
    """EMA throughput counters keyed by unit (e.g. 'edges', 'windows')."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.rates: Dict[str, float] = {}
        self._last: Optional[float] = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def step(self, **units: int) -> Dict[str, float]:
        """Record one step's work (e.g. step(edges=500000, windows=512))."""
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return dict(self.rates)
        dt = max(now - self._last, 1e-9)
        self._last = now
        for unit, count in units.items():
            rate = count / dt
            if unit in self.rates:
                self.rates[unit] = (1 - self.alpha) * self.rates[unit] + self.alpha * rate
            else:
                self.rates[unit] = rate
        return dict(self.rates)

    def summary(self) -> str:
        return " ".join(f"{u}/s={r:,.0f}" for u, r in self.rates.items())


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def block_on(x) -> None:
    """Wait until the device has computed ``x`` (a tensor, or the first
    tensor in a nest of lists, tuples and dicts), by reading its sum back to
    the host."""
    t = _first_tensor(x)
    if t is None:
        raise TypeError(f"block_on: no tensor in {type(x).__name__}")
    float(t.sum())
