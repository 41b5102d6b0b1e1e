"""K1-fwd's share of its roofline in the train step: its operations and
bytes for the step's samples (work.k1_fwd_work, rays x work.samples) over
the device time of the kernels launched under its wrapper's span
``copenerf.kernel.rendercore_fwd``."""

from portbench import spans, work
from portbench.metrics._common import roofline_pct


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    spans.report(run)
    rows = run.rays_per_unit * work.samples(run.cfg) * run.units
    flop, nbytes = work.k1_fwd_work(run.cfg, rows)
    return roofline_pct(run, flop, nbytes, run.trace.kernel_s_under(
        ["copenerf.kernel.rendercore_fwd"]))
