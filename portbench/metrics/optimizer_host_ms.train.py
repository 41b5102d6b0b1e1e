"""Host milliseconds a train step in the optimizers
(``copenerf.step.optimizer``: the learning rates and ``zero_grad`` at the
start, both Adam steps at the end), inclusive, from the spans stretch."""

from portbench import spans


def read(run):
    return spans.host_ms(run, "train", "copenerf.step.optimizer")
