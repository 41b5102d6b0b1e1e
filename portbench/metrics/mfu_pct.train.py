"""The train step's model operations over the wall time of the traced
run's units run untraced, against
the dense TF32 peak (training/step.py)."""

from portbench.metrics._common import mfu_pct


def read(run):
    return mfu_pct(run, "train")
