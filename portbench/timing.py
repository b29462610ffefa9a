"""Clocks and traces: the measured window of a closed loop, with CUDA
events at each step's end, and the profiler's trace reduced to busy time,
idle gaps and kernel groups.

The completeness check of ``profile`` is a copy of ``chip_smoke.py``'s
``traced``, kept here so that the program's tree can change without moving
the yardstick.
"""

from __future__ import annotations

import glob
import json
import os
import statistics
import tempfile
import time
from typing import Callable, Dict, List, Tuple

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the port's kernels: the wrapper's launch counter and the kernel's name
PORT_KERNELS = (("bsr_spmm", "bsr_spmm_kernel"), ("gcn_fused_fwd", "gcn_fused_kernel"),
                ("gcn_fused_bwd", "gcn_fused_bwd_kernel"))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(step: Callable[[int], None], seconds: float,
                device: torch.device) -> Dict[str, object]:
    """Run ``step(i)`` back to back, as a training loop does, with no host
    sync between steps, until ``seconds`` have passed on the host clock (and
    three steps at least), then synchronise once. Returns the window's
    seconds, the steps completed, and the gaps (ms) between consecutive step
    ends: CUDA events recorded on the stream after each step (host clock on
    the CPU)."""
    cuda = device.type == "cuda"
    ends = []
    sync(device)
    t0 = time.perf_counter()
    n = 0
    while True:
        step(n)
        n += 1
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ends.append(ev)
        else:
            ends.append(time.perf_counter())
        if n >= 3 and time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    window = time.perf_counter() - t0
    if cuda:
        gaps = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
    else:
        gaps = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
    return {"seconds": window, "steps": n, "gaps_ms": gaps}


def p95(values: List[float]) -> float:
    """The 95th percentile (``statistics.quantiles``' exclusive method)."""
    return statistics.quantiles(values, n=20)[-1]


class Trace:
    """What one profiled stretch left: device events and host events as
    (name, start us, duration us), the stretch's host-clock seconds, and
    whether the trace held every kernel the stretch launched."""

    def __init__(self, device_events, host_events, window_s: float, complete: bool):
        self.device_events = device_events
        self.host_events = host_events
        self.window_s = window_s
        self.complete = complete

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device events' intervals, sorted (us)."""
        merged: List[Tuple[float, float]] = []
        for _, start, dur in sorted(self.device_events, key=lambda e: e[1]):
            end = start + dur
            if merged and start <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], end))
            else:
                merged.append((start, end))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """Seconds the device sat idle between its operations, summed by
        the innermost host event running at each gap's middle, largest
        first."""
        busy = self.busy_intervals()
        host = sorted(self.host_events, key=lambda e: e[1])
        sums: Dict[str, float] = {}
        active: list = []
        nxt = 0
        # the gaps come in time order: sweep the host events along them
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid = (a + b) / 2
            while nxt < len(host) and host[nxt][1] <= mid:
                active.append(host[nxt])
                nxt += 1
            active = [e for e in active if e[1] + e[2] >= mid]
            name = max(active, key=lambda e: e[1])[0] if active else "outside torch ops"
            sums[name[:80]] = sums.get(name[:80], 0.0) + (b - a) / 1e6
        return sorted(sums.items(), key=lambda kv: -kv[1])[:top]

    def by_group(self, top: int = 10) -> List[Tuple[str, float]]:
        """Device seconds by kernel group (``kernel_groups/*.json``, the
        group of lowest ``priority`` whose words the lower-case name holds),
        largest first."""
        groups = kernel_groups()
        sums: Dict[str, float] = {}
        for name, _, dur in self.device_events:
            low = name.lower()
            group = next((g["name"] for g in groups if any(w in low for w in g["words"])),
                         "other")
            sums[group] = sums.get(group, 0.0) + dur / 1e6
        return sorted(sums.items(), key=lambda kv: -kv[1])[:top]


def kernel_groups() -> List[dict]:
    groups = []
    for path in sorted(glob.glob(os.path.join(HERE, "kernel_groups", "*.json"))):
        with open(path) as f:
            groups.append(json.load(f))
    return sorted(groups, key=lambda g: g["priority"])


def _read_trace(prof) -> Tuple[list, list]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        item = (e.get("name", ""), float(e["ts"]), float(e["dur"]))
        if e.get("cat") in DEVICE_CATEGORIES:
            device.append(item)
        elif not item[0].startswith("PyTorch Profiler"):  # the profiler's own range
            host.append(item)
    return device, host


def profile(run: Callable[[], None], device: torch.device, attempts: int = 3) -> Trace:
    """Trace ``run()`` with torch.profiler (host and card), up to
    ``attempts`` times until the trace is complete: it holds a device event,
    and each of the port's kernels comes as often as its wrapper counted
    launches (``chromegcn_tpu_torch.ops._build.LAUNCHES``). On the H100 the
    profiler has returned traces without some of the kernels that ran.
    Returns the last trace, complete or not."""
    from chromegcn_tpu_torch.ops import _build

    trace = None
    for _ in range(attempts):
        before = dict(_build.LAUNCHES)
        with torch.profiler.profile(activities=activities(device)) as prof:
            sync(device)
            t0 = time.perf_counter()
            run()
            sync(device)
            window = time.perf_counter() - t0
        trace = trace_of(prof, window, before)
        if trace.complete:
            break
    return trace


def activities(device: torch.device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def trace_of(prof, window_s: float, launches_before: Dict[str, int]) -> Trace:
    """The Trace of a finished profiler over a stretch of ``window_s``
    host seconds, complete if it holds a device event and each of the
    port's kernels as often as its wrapper counted launches since
    ``launches_before``."""
    from chromegcn_tpu_torch.ops import _build

    device_events, host_events = _read_trace(prof)
    ours = all(
        sum(1 for name, _, _ in device_events if kernel in name)
        == _build.LAUNCHES[launcher] - launches_before.get(launcher, 0)
        for launcher, kernel in PORT_KERNELS)
    return Trace(device_events, host_events, window_s, bool(device_events) and ours)
