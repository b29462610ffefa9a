"""spmm_launches (launches): kernel B1's launches (``bsr_spmm``) a train
step, from the program's counter of its own launches as each ``train_step``
span records it, over the steps ``fwd_device_ms`` runs: 8 on the flat form
(2 layers x 2 strands x forward and backward), 16 on the hybrid."""

from portbench import spans


def read(session):
    return spans.step_count(session, "bsr_spmm")
