"""The share of the wall time of a traced run's units, run untraced, in
which none of their kernels, copies or memsets ran on the card, in the render cells."""

from portbench.metrics._common import idle_pct


def read(run):
    return idle_pct(run, "render")
