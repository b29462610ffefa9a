"""device_idle (%): the share of a profiled stretch of train steps (host
clock, steps launched back to back) in which no operation ran on the device,
from the union of the trace's kernel, copy and fill intervals. Nothing when
the profiler's trace lost kernels in every try."""


def read(session):
    trace = getattr(session, "trace", None)
    if trace is None or not trace.complete:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
