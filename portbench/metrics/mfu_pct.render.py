"""A view's model operations over the wall time of the traced
run's units run untraced, against the dense
TF32 peak (evaluation/render.py)."""

from portbench.metrics._common import mfu_pct


def read(run):
    return mfu_pct(run, "render")
