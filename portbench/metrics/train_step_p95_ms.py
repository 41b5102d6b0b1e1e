"""The 95th percentile of every step in the window; a step is the time
between the CUDA events recorded after consecutive steps."""

from portbench.metrics._common import p95_ms


def read(run):
    return p95_ms(run.unit_ms) if run.kind == "train" else None
