"""fwd_device_ms (ms): the program's ``forward`` span a train step (both
strands' model calls and the ``loss`` span inside it), timed on the device
by the CUDA events the program records at its start and end with device
timing on; mean over 20 ``session.step`` calls after 3 to warm up, which
the three device readers share (``portbench/spans.py:steps``). Nothing
on the CPU or from a program without spans."""

from portbench import spans


def read(session):
    return spans.step_device_ms(session, "forward")
