"""K3-bwd's share of its roofline in the stage-1 train step (the sdf
consistency's value backward): its operations and bytes for the step's
samples (work.k3_bwd_work, rays x work.samples) over the device time of
its runs, ``sdf_value_bwd_kernel`` and the ``wgrad_*`` reduction that
follows it on its stream (csrc/sdf_value_bwd.cu, wgrad.cu;
``_common.K3_BWD``). A stage-2 step launches no K3: None."""

from portbench import work
from portbench.metrics._common import K3_BWD, WGRAD, roofline_pct


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    rows = run.rays_per_unit * work.samples(run.cfg) * run.units
    flop, nbytes = work.k3_bwd_work(run.cfg, rows)
    return roofline_pct(run, flop, nbytes,
                        run.trace.kernel_runs_s(K3_BWD, WGRAD))
