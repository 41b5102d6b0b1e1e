"""Host milliseconds a stage-1 step in the motion chain
(``copenerf.step.motion``: the full-video integration, its inverse and the
consistency transform), inclusive, from the spans stretch (no profiler)."""

from portbench import spans


def read(run):
    return spans.host_ms(run, "train", "copenerf.step.motion")
