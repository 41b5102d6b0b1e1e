"""Rays of every whole view in the window, over their time."""

from portbench.metrics._common import rate


def read(run):
    return rate(run, "render")
