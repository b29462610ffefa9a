"""snapshot_s (s): host seconds an epoch in the program's ``snapshot``
spans (``utils/evals.py:EpochLogger._snapshot``, one compressed ``.npz`` of
the valid and test predictions each), mean over the complete ``epoch``
spans after the warm-up (the traced epoch, ended by the loop's stop, is
not among them)."""

from portbench import spans


def read(session):
    epochs = spans.window_epochs()
    if epochs is None:
        return None
    per_epoch = [sum(c.end_ns - c.start_ns for c in kids if c.name == "snapshot") / 1e9
                 for _, kids in epochs]
    return sum(per_epoch) / len(per_epoch)
