"""Host milliseconds a train step in the losses after the render
(``copenerf.step.losses``: every loss term, the scene flow, the flow-rgb
references, the metrics), inclusive, from the spans stretch."""

from portbench import spans


def read(run):
    return spans.host_ms(run, "train", "copenerf.step.losses")
