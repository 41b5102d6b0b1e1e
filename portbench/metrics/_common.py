"""Shared arithmetic of the metric readers. A reader is a file of its own
named after its metric, with one function ``read(run)`` that returns the
number or None when the run has nothing for it to read; ``run`` is the
``portbench.run.Record`` of the run."""

from __future__ import annotations

import math

from portbench import work

# The kernels of each roofline, as fragments of their names on the device
# trace (``Trace.kernel_runs_s``): found by name and stream order, never by
# the host range that launched them, so that a CUDA graph's replay reads
# the same work. A backward's run is its row kernel and the weight-gradient
# reduction (``csrc/wgrad.cu``: ``wgrad_*``) that follows it on its stream;
# K1-bwd and K3-bwd launch that reduction under the same names.
K1_FWD = ("rendercore_fwd_kernel<false>",)     # <true> is K6-fwd
K1_BWD = ("rendercore_bwd_kernel<false>",)     # <true> is K6-bwd
K2 = ("sdf_value_kernel",)                     # K3-fwd too, in a train step
K3_BWD = ("sdf_value_bwd_kernel",)             # K7-bwd is sdf_out_bwd_kernel
WGRAD = ("wgrad_",)


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
                        run.trace.kernel_runs_s(K1_BWD, WGRAD))
