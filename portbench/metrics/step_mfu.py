"""step_mfu (%): the operations the architecture needs for one train step
(``portbench/flops.py``, from the configuration's shapes) over the traced
run's own step time, measured with the profiler off, against the card's
f32-faithful peak (3xTF32, 165 TFLOP/s)."""

from portbench import flops


def read(session):
    step_flops = getattr(session, "step_flops", None)
    if step_flops is None:
        return None
    return 100.0 * step_flops() / (session.step_ms / 1e3) / flops.F32_FAITHFUL_FLOPS
