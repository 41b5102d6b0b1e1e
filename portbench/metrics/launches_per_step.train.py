"""Device kernels of every kind launched per train step in the traced
window: the glue's count (ops/renderer.py, ops/sampling.py,
training/losses.py, poses/, torch.optim) beside the port's own kernels."""


def read(run):
    if run.kind != "train" or run.trace is None or run.units <= 0:
        return None
    return run.trace.launches / run.units
