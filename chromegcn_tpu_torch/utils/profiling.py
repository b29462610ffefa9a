"""Spans, counters and traces of the port's layers (port of
chromegcn_tpu/utils/profiling.py, less its ``Throughput``).

- ``span(name, **attrs)``: a context manager that times the enclosed block
  on the host clock and keeps it, with its parent span, its attributes and
  whether it ended by an exception, in a ring of the last ``RING`` spans;
  per-name totals (count, host seconds, device ms) outlive the ring. Always
  on: the runner's log lines and metrics read their durations. While a
  torch.profiler runs, a span also enters ``record_function(name)``, so it
  lands in the profiler's trace under its own name; otherwise it never does.
- ``device_timing(True)``: every span also records a CUDA event on the
  current stream at its start and its end (pooled, resolved when finished);
  off, none is made.
- ``spans``, ``totals``, ``resolve``, ``export``, ``summary``: what was
  recorded, as objects, as a Chrome trace on the profiler's clock, and as
  one log line per span name.
- ``trace``: a ``torch.profiler`` trace of the enclosed block (host and
  card), written as a Chrome trace (``trace.json``, for Perfetto or
  chrome://tracing) under ``log_dir``;
- ``block_on``: wait for a result by reading one number of it back.

The recording state is the process's: one thread opens and closes spans.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import time
from typing import Dict, List, Mapping, Optional

import torch

# spans kept in memory, the oldest dropped first
RING = 1 << 16

# the profiler's Chrome trace stamps the system clock (time_ns); spans are
# timed on perf_counter_ns and moved onto it by this one pair of readings
_CLOCK = (time.time_ns(), time.perf_counter_ns())

_profiler_enabled = torch._C._autograd._profiler_enabled
_ids = itertools.count(1)
_ring: collections.deque = collections.deque(maxlen=RING)
_totals: Dict[str, list] = {}   # name -> [count, host ns, device ms, spans with device ms]
_open: list = []                # the spans entered and not yet left, innermost last
_device = False
_events: list = []              # CUDA events free for reuse
_pending: collections.deque = collections.deque()  # ended spans, device time unresolved
_cut: Optional[list] = None     # [profiler, train steps left] of a ``trace(steps=...)``


class Span:
    """One timed block: ``name``, ``attrs``, ``id``, ``parent`` (the id of
    the span it opened in, 0 for none), host ``start_ns`` and ``end_ns``
    (perf_counter), ``error`` (ended by an exception) and ``device_ms``
    (None unless device timing was on and the events are resolved)."""

    __slots__ = ("name", "attrs", "id", "parent", "start_ns", "end_ns", "error", "device_ms",
                 "_record", "_marks", "_counters", "_before")

    def __init__(self, name: str, counters: Optional[Mapping[str, int]], attrs: dict):
        self.name, self.attrs, self._counters = name, attrs, counters
        self.end_ns = None
        self.error = False
        self.device_ms = None

    @property
    def seconds(self) -> float:
        """Host seconds from the start to the end, or to now while open."""
        end = self.end_ns if self.end_ns is not None else time.perf_counter_ns()
        return (end - self.start_ns) / 1e9

    def __enter__(self) -> "Span":
        self.id = next(_ids)
        self.parent = _open[-1].id if _open else 0
        _open.append(self)
        self._record = None
        if _profiler_enabled():
            self._record = torch.autograd.profiler.record_function(self.name)
            self._record.__enter__()
        if self._counters is not None:
            self._before = dict(self._counters)
        self._marks = None
        if _device:
            self._marks = (_event(), _event())
            self._marks[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, kind, value, tb) -> bool:
        self.end_ns = time.perf_counter_ns()
        self.error = kind is not None
        if self._marks is not None:
            self._marks[1].record()
            _pending.append(self)
        if self._record is not None:
            self._record.__exit__(kind, value, tb)
            self._record = None
        if self._counters is not None:
            before = self._before
            self.attrs.update((k, v - before.get(k, 0)) for k, v in self._counters.items())
        _open.pop()
        _ring.append(self)
        total = _totals.get(self.name)
        if total is None:
            total = _totals[self.name] = [0, 0, 0.0, 0]
        total[0] += 1
        total[1] += self.end_ns - self.start_ns
        if _pending:
            _resolve_ready()
        if _cut is not None and self.name == "train_step":
            _count_step()
        return False


def span(name: str, /, *, counters: Optional[Mapping[str, int]] = None, **attrs) -> Span:
    """A span named ``name`` with attributes ``attrs``; with ``counters``
    (a mapping of counts, such as ``ops._build.LAUNCHES``) it also records,
    as attributes, how much each count grew while it was open."""
    return Span(name, counters, attrs)


def _event():
    return _events.pop() if _events else torch.cuda.Event(enable_timing=True)


def _resolve(s: Span) -> None:
    start, end = s._marks
    s.device_ms = start.elapsed_time(end)
    s._marks = None
    _events.extend((start, end))
    total = _totals[s.name]
    total[2] += s.device_ms
    total[3] += 1


def _resolve_ready() -> None:
    """Resolve the ended spans whose events the device has passed, oldest
    first, without waiting for it."""
    while _pending and _pending[0]._marks[1].query() and _pending[0]._marks[0].query():
        _resolve(_pending.popleft())


def resolve() -> None:
    """Wait for the device and resolve every ended span's device time."""
    if _pending:
        torch.cuda.synchronize()
        while _pending:
            _resolve(_pending.popleft())


def device_timing(on: bool) -> None:
    """Record CUDA events at every span's start and end from now on (where
    there is a card), or stop doing so."""
    global _device
    _device = bool(on) and torch.cuda.is_available()


def spans() -> List[Span]:
    """The finished spans in the ring, in the order they ended."""
    return list(_ring)


def totals() -> Dict[str, dict]:
    """Per span name since the process started: ``count``, ``host_s`` and
    ``device_ms`` (summed over the spans whose device time was resolved,
    None where there is none)."""
    return {name: {"count": n, "host_s": ns / 1e9, "device_ms": ms if timed else None}
            for name, (n, ns, ms, timed) in _totals.items()}


def _wall_ns(perf_ns: int) -> int:
    return _CLOCK[0] + perf_ns - _CLOCK[1]


def export(path: str, counters: Optional[Mapping[str, Mapping[str, int]]] = None) -> None:
    """Write the ring as a Chrome trace to ``path``: one complete event a
    span (``ts`` in us on the profiler's clock, the system clock less the
    file's ``baseTimeNanoseconds``), one counter event for each mapping in
    ``counters``, and the per-name totals under ``spanTotals``."""
    resolve()
    done = spans()
    base = min((_wall_ns(s.start_ns) for s in done), default=time.time_ns())
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
               "args": {"name": "spans"}}]
    for s in done:
        args = dict(s.attrs, id=s.id, parent=s.parent, error=s.error)
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        events.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": 0,
                       "ts": (_wall_ns(s.start_ns) - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    end = max((s.end_ns for s in done), default=time.perf_counter_ns())
    for name, counts in (counters or {}).items():
        events.append({"ph": "C", "name": name, "pid": pid, "tid": 0,
                       "ts": (_wall_ns(end) - base) / 1e3, "args": dict(counts)})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "baseTimeNanoseconds": base,
                   "displayTimeUnit": "ms", "spanTotals": totals()}, f)


def summary() -> List[str]:
    """One line per span name: count, host seconds and device ms."""
    resolve()
    lines = []
    for name, t in sorted(totals().items(), key=lambda kv: -kv[1]["host_s"]):
        device = "not timed" if t["device_ms"] is None else f"{t['device_ms']:.3f} ms"
        lines.append(f"span {name}: {t['count']} x, host {t['host_s']:.3f} s, device {device}")
    return lines


def _count_step() -> None:
    global _cut
    _cut[1] -= 1
    if _cut[1] <= 0:
        _cut[0].stop()
        _cut = None


@contextlib.contextmanager
def trace(log_dir: str, steps: Optional[int] = None):
    """Trace the enclosed block with torch.profiler (CPU, and CUDA where
    there is a card) into ``log_dir/trace.json``; yields the profiler. With
    ``steps``, the profiler stops once that many ``train_step`` spans have
    ended."""
    global _cut
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    if steps is not None:
        _cut = [prof, steps]
    try:
        yield prof
    finally:
        if steps is None or _cut is not None:
            _cut = None
            prof.stop()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
