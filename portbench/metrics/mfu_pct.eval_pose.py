"""The pose step's model operations (no weight gradients: the fields are
frozen) over the wall time of the traced
run's units run untraced, against the dense TF32 peak
(evaluation/evaluator.py)."""

from portbench.metrics._common import mfu_pct


def read(run):
    return mfu_pct(run, "eval_pose")
