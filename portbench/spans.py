"""What the readers of the program's own spans and counters share
(``chromegcn_tpu_torch/utils/profiling.py``: ``span``, ``spans``,
``totals``, ``device_timing``, ``resolve``).

A program without them gives nothing: each function here returns None
there and raises nothing, so a reader's line leaves its metric out.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Tuple

# train steps run to warm up, then read, by the step readers
WARM = 3
STEPS = 20
_TRACER = ("span", "spans", "totals", "device_timing", "resolve")


def tracer():
    """The program's ``utils/profiling`` module, or None where it has no
    tracer."""
    try:
        module = importlib.import_module("chromegcn_tpu_torch.utils.profiling")
    except ImportError:
        return None
    return module if all(hasattr(module, name) for name in _TRACER) else None


def children(done) -> Dict[int, list]:
    """The spans of ``done`` by the id of the span they opened in."""
    out: Dict[int, list] = {}
    for s in done:
        out.setdefault(s.parent, []).append(s)
    return out


def _under(span, kids: Dict[int, list]):
    for child in kids.get(span.id, []):
        yield child
        yield from _under(child, kids)


def steps(session) -> Optional[List[Tuple[object, Dict[int, list]]]]:
    """The ``train_step`` spans of STEPS steps of ``session.step`` after
    WARM more, run with the program's device timing on, each with the
    spans by parent; run once a session and kept on it."""
    if hasattr(session, "_program_steps"):
        return session._program_steps
    prof, step = tracer(), getattr(session, "step", None)
    found = None
    if prof is not None and step is not None:
        mark = max((s.id for s in prof.spans()), default=0)
        prof.device_timing(True)
        try:
            for i in range(WARM + STEPS):
                step(i)
            prof.resolve()
        finally:
            prof.device_timing(False)
        done = [s for s in prof.spans() if s.id > mark]
        kids = children(done)
        found = [(s, kids) for s in done if s.name == "train_step"][WARM:] or None
    session._program_steps = found
    return found


def step_device_ms(session, name: str) -> Optional[float]:
    """The mean device ms a step of the spans called ``name`` inside each
    ``train_step``; None where any of them has no device time (the CPU,
    or a program that times nothing on the device)."""
    if getattr(session, "device", None) is None or session.device.type != "cuda":
        return None
    found = steps(session)
    if not found:
        return None
    per_step = []
    for s, kids in found:
        times = [c.device_ms for c in _under(s, kids) if c.name == name]
        if not times or any(t is None for t in times):
            return None
        per_step.append(sum(times))
    return sum(per_step) / len(per_step)


def step_count(session, counter: str) -> Optional[float]:
    """The mean a ``train_step`` of its attribute ``counter`` (the kernel
    launches made while it was open)."""
    found = steps(session)
    if not found:
        return None
    return sum(float(s.attrs.get(counter, 0)) for s, _ in found) / len(found)


def total_host_s(name: str) -> Optional[float]:
    """Host seconds in the spans called ``name`` since the process started."""
    prof = tracer()
    if prof is None or name not in prof.totals():
        return None
    return prof.totals()[name]["host_s"]


def window_epochs() -> Optional[List[Tuple[object, list]]]:
    """The last run's ``epoch`` spans after its first (the warm-up) that
    ended without an exception, each with its child spans. The last run is
    the last stretch of epochs numbered one after another."""
    prof = tracer()
    if prof is None:
        return None
    done = prof.spans()
    epochs = [s for s in done if s.name == "epoch"]
    if not epochs:
        return None
    run = [epochs[-1]]
    for s in reversed(epochs[:-1]):
        if s.attrs.get("epoch") != run[-1].attrs.get("epoch", 0) - 1:
            break
        run.append(s)
    window = [e for e in reversed(run[:-1]) if not e.error]
    if not window:
        return None
    kids = children(done)
    return [(e, kids.get(e.id, [])) for e in window]


def self_seconds(span, kids: list) -> float:
    """The span's host seconds less the part its children cover."""
    covered, end = 0, None
    for c in sorted(kids, key=lambda c: c.start_ns):
        start = c.start_ns if end is None else max(c.start_ns, end)
        if c.end_ns > start:
            covered += c.end_ns - start
            end = c.end_ns
    return (span.end_ns - span.start_ns - covered) / 1e9
