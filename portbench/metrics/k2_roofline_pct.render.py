"""K2's share of its roofline in a whole-view render: its operations and
bytes for the view's swept points (work.k2_work, rays x work.sweep_points;
the padded tail of the last chunk is not counted) over the device time of
its kernel ``sdf_value_kernel`` (csrc/sdf_value.cu; ``_common.K2``). A
render launches no K3, which shares the kernel."""

from portbench import spans, work
from portbench.metrics._common import K2, roofline_pct


def read(run):
    if run.kind != "render" or run.trace is None:
        return None
    spans.report(run)
    rows = run.rays_per_unit * work.sweep_points(run.cfg) * run.units
    flop, nbytes = work.k2_work(run.cfg, rows)
    return roofline_pct(run, flop, nbytes, run.trace.kernel_runs_s(K2))
