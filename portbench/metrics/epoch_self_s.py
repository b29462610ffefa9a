"""epoch_self_s (s): the program's ``epoch`` span less the part its child
spans (passes, metrics, logs, snapshots, checkpoint) cover, mean over the
epochs ``snapshot_s`` reads: the epoch's time that no named span explains."""

from portbench import spans


def read(session):
    epochs = spans.window_epochs()
    if epochs is None:
        return None
    return sum(spans.self_seconds(e, kids) for e, kids in epochs) / len(epochs)
