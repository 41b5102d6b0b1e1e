"""K1-fwd's share of its roofline in the train step: its operations and
bytes for the step's samples (work.k1_fwd_work, rays x work.samples) over
the device time of its kernel ``rendercore_fwd_kernel<false>``
(``_common.K1_FWD``)."""

from portbench import spans, work
from portbench.metrics._common import K1_FWD, roofline_pct


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    spans.report(run)
    rows = run.rays_per_unit * work.samples(run.cfg) * run.units
    flop, nbytes = work.k1_fwd_work(run.cfg, rows)
    return roofline_pct(run, flop, nbytes, run.trace.kernel_runs_s(K1_FWD))
