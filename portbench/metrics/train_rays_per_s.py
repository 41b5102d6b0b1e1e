"""Rays of every step completed in the window, over the window (which ends
on a device sync)."""

from portbench.metrics._common import rate


def read(run):
    return rate(run, "train")
