"""K1-fwd's share of its roofline in a whole-view render: its operations
and bytes for the view's rays (work.k1_fwd_work; the padded tail of the
last chunk is not counted) over the device time of its kernel
``rendercore_fwd_kernel<false>`` (csrc/rendercore_fwd.cu; ``<true>`` is
K6-fwd; ``_common.K1_FWD``)."""

from portbench import work
from portbench.metrics._common import K1_FWD, roofline_pct


def read(run):
    if run.kind != "render" or run.trace is None:
        return None
    rows = run.rays_per_unit * work.samples(run.cfg) * run.units
    flop, nbytes = work.k1_fwd_work(run.cfg, rows)
    return roofline_pct(run, flop, nbytes, run.trace.kernel_runs_s(K1_FWD))
