"""bwd_device_ms (ms): the program's ``backward`` span a train step
(``loss.backward()``; autograd runs the backward on the forward's stream,
so the span's CUDA events bracket its kernels), over the same steps as
``fwd_device_ms``."""

from portbench import spans


def read(session):
    return spans.step_device_ms(session, "backward")
