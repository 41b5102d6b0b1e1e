"""Rays of every test-time pose step in the window, over the window."""

from portbench.metrics._common import rate


def read(run):
    return rate(run, "eval_pose")
