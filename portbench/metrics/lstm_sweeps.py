"""lstm_sweeps (sweeps): the LSTM layers run a train step, from the
program's counter of ``lstm_forward`` calls (each one layer, both
directions, over the whole chromosome) as each ``train_step`` span records
it, over the steps ``fwd_device_ms`` runs: 4 for ChromeRNN (2 strands x 2
layers). Nothing from a program without the counter."""

from portbench import spans

COUNTER = "lstm_sweeps"


def read(session):
    found = spans.steps(session)
    if not found or not any(COUNTER in s.attrs for s, _ in found):
        return None
    return spans.step_count(session, COUNTER)
