"""metrics_s (s): host seconds in ``runner.compute_metrics`` per epoch of
the window (the train, valid and test splits' calls summed), mean over the
window's epochs."""


def read(session):
    return getattr(session, "spans", {}).get("compute_metrics")
