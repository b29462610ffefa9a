"""bce_launches (launches): the masked BCE's kernel launches a train step
(``bce_sum``, two for the loss's sum, and ``bce_sum_bwd``, one for its
gradient), from the program's counters of its own launches as each
``train_step`` span records them: 3 where the loss runs on the card's
kernels, 0 where it takes the plain torch formula."""

from portbench import spans


def read(session):
    counts = [spans.step_count(session, name) for name in ("bce_sum", "bce_sum_bwd")]
    return None if None in counts else sum(counts)
