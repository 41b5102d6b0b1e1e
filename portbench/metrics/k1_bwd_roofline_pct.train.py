"""K1-bwd's share of its roofline in the train step: its operations and
bytes with weight gradients (work.k1_bwd_work) over the device time of
every kernel launched under the autograd node RenderCoreBackward
(ops/kernels/rendercore.py, csrc/rendercore_bwd*, wgrad.cu)."""

from portbench.metrics._common import k1_bwd_pct


def read(run):
    return k1_bwd_pct(run, "train", weight_grads=True)
