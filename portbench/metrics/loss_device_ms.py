"""loss_device_ms (ms): the program's ``loss`` span a train step (the
GCN's head, the masked BCE and the probabilities; the window model's loss
and probabilities), device time from its CUDA events, over the same steps
as ``fwd_device_ms``."""

from portbench import spans


def read(session):
    return spans.step_device_ms(session, "loss")
