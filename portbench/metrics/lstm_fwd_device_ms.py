"""lstm_fwd_device_ms (ms): the program's ``lstm`` spans a train step (each
``lstm_forward`` call: one bidirectional layer over the whole chromosome,
forward only; the backward runs inside ``backward``), device time from their
CUDA events, summed a step and averaged over the steps ``fwd_device_ms``
runs. On the CPU, where an operation ends before the next is launched, the
spans' host time. Nothing from a program without ``lstm`` spans."""

from portbench import spans


def read(session):
    device = getattr(session, "device", None)
    if device is not None and device.type == "cuda":
        return spans.step_device_ms(session, "lstm")
    found = spans.steps(session)
    if not found:
        return None
    per_step = [sum(c.end_ns - c.start_ns for c in spans._under(s, kids) if c.name == "lstm")
                / 1e6 for s, kids in found]
    return sum(per_step) / len(per_step) if any(per_step) else None
