"""Shared arithmetic of the metric readers. A reader is a file of its own
named after its metric, with one function ``read(run)`` that returns the
number or None when the run has nothing for it to read; ``run`` is the
``portbench.run.Record`` of the run."""

from __future__ import annotations

import math

from portbench import work

RENDER_CORE_BWD = ("RenderCoreBackward",)   # the autograd node of K1-bwd
# K1-fwd outside autograd (the render path) is named by its kernel alone.
RENDER_CORE_FWD_KERNELS = ("rendercore_fwd_kernel<false>",)


def rate(run, kind):
    if run.kind != kind or run.window_s <= 0:
        return None
    return run.units * run.rays_per_unit / run.window_s


def p95_ms(values):
    """The 95th percentile by nearest rank: the smallest value at or above
    95% of the values."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def mfu_pct(run, kind):
    """Model operations of a traced run's units over the wall time of the
    same number of units run untraced just before, against the dense TF32
    peak."""
    if run.kind != kind or not run.plain_s:
        return None
    return (100.0 * run.unit_flop * run.units / run.plain_s
            / work.TF32_PEAK)


def idle_pct(run, kind):
    """The share of the untraced stretch's wall time that the traced
    stretch's device operations (kernels, copies, memsets; the same number
    of units) leave idle."""
    if run.kind != kind or run.trace is None or not run.plain_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.plain_s)


def roofline_pct(run, flop, nbytes, seconds):
    """The least time of the work over the time its kernels took."""
    if seconds <= 0:
        return None
    return 100.0 * work.roofline_s(flop, nbytes) / seconds


def k1_bwd_pct(run, kind, weight_grads):
    if run.kind != kind or run.trace is None:
        return None
    rows = run.rays_per_unit * work.samples(run.cfg) * run.units
    flop, nbytes = work.k1_bwd_work(run.cfg, rows, weight_grads)
    return roofline_pct(run, flop, nbytes,
                        run.trace.kernel_s_under(RENDER_CORE_BWD))
