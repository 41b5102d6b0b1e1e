"""K1-bwd's share of its roofline in the test-time pose step: its
operations and bytes without weight gradients (the fields are frozen)
over the device time of its runs (``_common.K1_BWD``), the reduction that
it still launches included."""

from portbench.metrics._common import k1_bwd_pct


def read(run):
    return k1_bwd_pct(run, "eval_pose", weight_grads=False)
