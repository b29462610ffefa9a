"""spmm_roofline (%): the least time of the step's sparse product and its
backward (``portbench/flops.py:spmm_bound_s``, the logical operator's bytes
at HBM bandwidth, twice) over their device time: ``ops/spmm.py``'s dispatch
on the cell's own graph and its backward through autograd, 20 calls after 3
to warm up, timed by a complete profiler trace as the union of every device
operation they run, whatever kernel runs it. (CUDA events around the calls
would time the host's autograd overhead between short kernels instead.)
Nothing when no complete trace came."""

from portbench import flops, timing

CALLS = 20


def read(session):
    product = getattr(session, "sparse_product", None)
    if product is None or session.device.type != "cuda":
        return None
    call = product()
    for _ in range(3):
        call()

    def calls():
        for _ in range(CALLS):
            call()
    trace = timing.profile(calls, session.device)
    if not trace.complete:
        return None
    bound_s = 2 * flops.spmm_bound_s(session.n_pad, session.nnz, session.cfg["nhid"])
    return 100.0 * bound_s / (trace.busy_s / CALLS)
