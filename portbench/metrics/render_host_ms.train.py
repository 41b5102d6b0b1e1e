"""Host milliseconds a train step in the render pass inside the step
(``copenerf.render`` under ``copenerf.step``: the importance sweeps' glue,
compositing, the kernel wrappers and packs), inclusive, from the spans
stretch."""

from portbench import spans


def read(run):
    return spans.host_ms(run, "train", "copenerf.render", "copenerf.step")
