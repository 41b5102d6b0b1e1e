"""K1-bwd's share of its roofline in the train step: its operations and
bytes with weight gradients (work.k1_bwd_work) over the device time of its
runs, ``rendercore_bwd_kernel<false>`` and the ``wgrad_*`` reduction that
follows it on its stream (csrc/rendercore_bwd*, wgrad.cu;
``_common.K1_BWD``)."""

from portbench.metrics._common import k1_bwd_pct


def read(run):
    return k1_bwd_pct(run, "train", weight_grads=True)
